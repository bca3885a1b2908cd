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
// The function is float32 sums of the products of the operands' values,
// whatever their types (the Pallas kernel widens both on load).
//
// Two partial kernels, by the keys' type, and one merge launch.  On the TPU
// the corpus streams through VMEM block by block with a running top-k
// carried across the sequential grid.  Here the grid is (query tiles,
// splits of N), the query tile fastest in launch order, so the blocks of
// one key range run together and the range comes from HBM about once; a
// block walks its split in key tiles and folds each tile's scores into
// running top-k lists, keyed (score desc, index asc), then writes one
// partial list per (query, split).  A second launch, one warp per query,
// merges the splits.
//
// float32 keys (cosine_topk_partial_kernel): a register-tiled float32 FMA
// GEMM.  kGroups groups of 128 threads, each thread a 4 x TN register
// patch (queries ty + 16 i, keys tx + 8 j), split every chunk of kDC
// columns of D between them; each chunk's q and key slices staged in
// shared memory with cp.async, 2 or 3 deep; rows padded to an odd count of
// 16-byte chunks (conflict-free key loads, broadcast query loads).  After
// each key tile of 8 TN rows (32, or 64 for large panels: the wrapper
// picks) the groups' partial scores meet in shared memory and kFold
// threads per query fold them.  No tensor cores: float32 products are not
// exact in any tensor-core type.  One lookup is 2 Q N D flops over N D 4
// bytes: at Q = 64 above the card's float32 balance (67 TFLOP/s over 3.35
// TB/s = 20 flops a byte), so the FMA rate bounds it.  bf16 q with float32
// keys is widened by the wrapper (exact) and takes this kernel.
//
// bf16 keys (cosine_topk_mma_kernel): bf16 tensor cores.  A bf16 x bf16
// product is exact in float32, so `mma.sync.m16n8k16` bf16 with float32
// accumulators computes the function.  bf16 q is one term; float32 q is
// split in the kernel into kF32Terms bf16 terms, hi = bf16(q), mid =
// bf16(q - hi), lo = bf16(q - hi - mid), each term's product with a key
// exact, the three leaving ~2^-24 |q| (float32's own rounding).  Two leave
// ~2^-18 |q|, a score off by up to ~2^-18 |q| |k| where the lo terms meet
// keys of their own sign (a card test builds such keys), so two are not
// taken though they save ~15 %.  The block's kBQ queries (32, or 16 when
// k > 4, whose lists take the registers) are split once, when the block
// starts, into shared memory (16-byte loads, kQUnroll in flight a thread),
// where they stay while the block walks its keys (a D wider than the room
// splits into slabs, staged again for each key tile: not at any width the
// port serves).  Keys are
// staged as they are, bf16, by cp.async 16 bytes a copy, in stages of
// kMmaBK = 64 columns (128 bytes a key row), kMmaStages deep.  Warp w
// multiplies all kBQ queries by keys 32 w .. 32 w + 31 of each 256-row
// key tile and stages those rows itself, into its own slice of the
// ring: it waits for its own copies only, and the loop has no block
// barrier, so one warp's copies or fold run under another's products.
// Each stage's products (ldmatrix fragments, kF32Terms products a k-step
// for float32 q) go to a zeroed fragment, added to the tile's sums with
// one rounding; after the tile's last stage the warp folds its fragments
// straight into its registers' top-k lists (each thread owns 2 kMT query
// rows and 8 of the warp's keys).  At the end the block's 32 lists a
// query (8 warps x 4 threads) go through shared memory and one warp a
// query merges them.  Rows padded by 16 bytes: conflict-free ldmatrix.
// Ragged Q, N and D are zero-filled and masked.  The host sizes its grid
// from the tiles and the blocks an SM that this file reports
// (cosine_topk_*_tile, cosine_topk_*blocks_per_sm).
//
// Bound (bf16 keys).  Bytes N D 2; operations 2 Q N D a term at the bf16
// rate (989 TFLOP/s; three terms: 329.7, the cheapest float32-accurate
// rate).  At Q = 64 the bytes bound it (N = 65536: 0.030 ms); at the cache
// program's Q = 1024, N = 2^20 float32 q the operations do (5.0 ms), and
// the key panel (1.6 GB) is read from L2 once per 32-query tile.  The
// kernel reaches about a third of the bf16 rate there: mma.sync issues
// below the warpgroup (wgmma) rate, every warp loads the block's query
// fragments again for its keys, and with one 8-warp block an SM (the
// staged queries fill shared memory) the products, copies and fold
// (`tests/torch_topk_variants.py` drops each in turn) each cost about a
// third of the time, latency that two warps a scheduler do not hide.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "ptx.cuh"

namespace {

constexpr int kBQ = 64;               // query rows per block (FMA kernel)
constexpr int kGroups = 2;            // thread groups sharing each D chunk
constexpr int kGroupThreads = 128;    // 16 (queries) x 8 (keys) patches
constexpr int kThreads = kGroups * kGroupThreads;      // 256
constexpr int kDG = 32;               // D columns per group per chunk
constexpr int kDC = kGroups * kDG;    // D columns per chunk
constexpr int kPitch = kDC + 4;       // floats per staged row (17 x 16 B)
constexpr int kFold = kThreads / kBQ; // threads folding one query's scores
constexpr float kNeg = -1e30f;
constexpr int kPosPad = 0x7fffffff;

// bf16-key kernel
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;          // 256
constexpr int kMmaNT = 4;             // n-tiles of 8 keys a warp
constexpr int kMmaWR = 8 * kMmaNT;    // key rows a warp stages (32)
constexpr int kMmaBN = kMmaWarps * kMmaWR;           // key rows a tile (256)
constexpr int kMmaBK = 64;            // D columns per stage (4 k-steps)
constexpr int kMmaKP = kMmaBK + 8;    // bf16 per staged key row (144 B)
constexpr int kMmaStages = 2;         // cp.async depth
constexpr int kQPad = 8;              // bf16 past each staged q row
constexpr int kQUnroll = 8;           // 16-byte q loads in flight a thread
constexpr int kF32Terms = 3;          // bf16 terms of a float32 query
constexpr int kSmemMax = 232448;      // opt-in shared memory of a block
constexpr int kMmaRingBytes = 2 * kMmaStages * kMmaBN * kMmaKP;
constexpr int kMmaBlocksPerSm = 1;    // the staged queries fill the SM

// float32-key blocks an SM: two, but one for k > 8, whose lists make
// ptxas spill 64-row tiles at two
constexpr int f32_blocks_per_sm(int km) { return km > 8 ? 1 : 2; }

using bf16_bits = uint16_t;           // a bf16 value's raw 16 bits

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

// The bf16-key kernel's block: kMT m-tiles of 16 queries (2, or 1 when the
// lists of k > 4 take the registers), 32 lists a query at the end.
template <int KM>
struct Mma {
  static constexpr int kMT = KM <= 4 ? 2 : 1;
  static constexpr int kBQ = 16 * kMT;
  static constexpr int kSrc = kMmaWarps * 4;    // lists a query
  static constexpr int kListBytes = kBQ * kSrc * KM * 8;
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

// k rounds of a warp-wide (score, index) argmax over the lanes' list
// heads, the winning lane dropping its head; lane 0 writes the winners.
// Indices are distinct across the lanes' lists, so one lane holds each.
template <int KM>
__device__ __forceinline__ void warp_merge(TopK<KM>& mine, int lane, int k,
                                           float* out_s, int* out_i) {
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
      out_s[i] = bs;
      out_i[i] = bp;
    }
  }
}

template <int KM, int TN, bool VEC>
__global__ void __launch_bounds__(kThreads, f32_blocks_per_sm(KM))
cosine_topk_partial_kernel(const float* __restrict__ q,
                           const float* __restrict__ keys,
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
  // 0..kBQ-1 the query slice, then kBN key rows; zeros past Q, r1 and D
  auto load = [&](int it) {
    const int t = it / n_chunks;
    const int d0 = (it - t * n_chunks) * kDC;
    const int kr0 = r0 + t * kBN;
    float* st = smem + (it % kStages) * Tl::kStageFloats;
    if (VEC) {
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
    ptx::cp_async_commit();
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
#pragma unroll
    for (int i = 0; i < KM; ++i) {    // unrolled: `all` stays in registers
      if (i < k) {
        part_s[base + i] = all.s[i];
        part_i[base + i] = all.p[i];
      }
    }
  }
}

// Two query values as TERMS bf16 terms, each a pair packed in one register
// (value a in the low half: the order of an mma fragment).  bf16 q is its
// own single term; float32 q is split, hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid): each subtraction is exact, so the terms sum to
// x within the last term's rounding.
template <int TERMS>
__device__ __forceinline__ void q_terms(bf16_bits a, bf16_bits b,
                                        uint32_t (&w)[TERMS]) {
  static_assert(TERMS == 1, "bf16 q is one term");
  w[0] = static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);
}

template <int TERMS>
__device__ __forceinline__ void q_terms(float a, float b,
                                        uint32_t (&w)[TERMS]) {
#pragma unroll
  for (int j = 0; j < TERMS; ++j) {
    w[j] = ptx::pack_bf16x2(a, b);
    a -= __uint_as_float(w[j] << 16);
    b -= __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Partial top-k of a (query tile, split) over bf16 keys; q is bf16 (TERMS
// = 1, TQ = bf16_bits) or float32 (TERMS = kF32Terms, TQ = float).  Shared
// memory: the key ring (kMmaRingBytes), then TERMS planes of the
// block's kBQ query rows, `ds` columns of D each (one slab; D > ds takes
// ceil(D / ds) slabs, each staged again per key tile).  vec bit 0: keys by
// 16-byte cp.async (D % 8 == 0, 16-byte aligned base), else element by
// element; bit 1: q by 16-byte loads, kQUnroll in flight a thread (D a
// multiple of 16 / sizeof(TQ), 16-byte aligned base), else in pairs.  Each
// stage's products go to a zeroed fragment, added to the tile's float32
// sums with one rounding: the tensor cores truncate as they accumulate, so
// a long chain of mma into one fragment drifts (~2e-6 over D 768 x 3
// terms), a stage's short one does not.
template <int KM, int TERMS, typename TQ>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocksPerSm)
cosine_topk_mma_kernel(const TQ* __restrict__ q,
                       const bf16_bits* __restrict__ keys,
                       const uint8_t* __restrict__ valid, int Q, int N, int D,
                       int k, int rows_per_split, int ds, int vec,
                       float* __restrict__ part_s, int* __restrict__ part_i) {
  constexpr int kMT = Mma<KM>::kMT;
  constexpr int kQT = Mma<KM>::kBQ;
  constexpr int kKS = kMmaBK / 16;    // k-steps a stage
  constexpr int kStages = kMmaStages;
  constexpr int NT = kMmaNT;
  constexpr int kWR = kMmaWR;         // key rows a warp multiplies
  constexpr int kBN = kMmaBN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_bits* ring = reinterpret_cast<bf16_bits*>(smem_raw);
  bf16_bits* qs = ring + kMmaRingBytes / 2;
  const int qp = ds + kQPad;          // bf16 per staged q row

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  bf16_bits* wring = ring + warp * kStages * kWR * kMmaKP;   // its slice
  const int q0 = blockIdx.x * kQT;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int r0 = split * rows_per_split;
  const int r1 = min(N, r0 + rows_per_split);
  const int n_tiles = r1 > r0 ? (r1 - r0 + kBN - 1) / kBN : 0;
  const int n_chunks = max(1, (D + kMmaBK - 1) / kMmaBK);
  const int cps = ds / kMmaBK;        // chunks a slab
  const int n_slabs = (n_chunks + cps - 1) / cps;
  const int n_steps = n_tiles * n_chunks;

  // the block's queries, columns sl * ds .. + ds, as TERMS bf16 planes
  auto load_q = [&](int sl) {
    const int d0 = sl * ds;
    if (vec & 2) {                    // 16 bytes a load, kQUnroll in flight
      constexpr int kV = 16 / sizeof(TQ);
      const int per_row = ds / kV;
      const int n_items = kQT * per_row;
      for (int i0 = tid; i0 < n_items; i0 += kMmaThreads * kQUnroll) {
        uint4 v[kQUnroll];
#pragma unroll
        for (int u = 0; u < kQUnroll; ++u) {
          const int i = i0 + u * kMmaThreads;
          const int r = i / per_row, c = (i - r * per_row) * kV;
          const int row = q0 + r, d = d0 + c;
          v[u] = i < n_items && row < Q && d < D
                     ? *reinterpret_cast<const uint4*>(q + (size_t)row * D +
                                                       d)
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kQUnroll; ++u) {
          const int i = i0 + u * kMmaThreads;
          if (i >= n_items) break;
          const int r = i / per_row, c = (i - r * per_row) * kV;
          if constexpr (TERMS == 1) {
            *reinterpret_cast<uint4*>(qs + r * qp + c) = v[u];
          } else {
            uint32_t lo[TERMS], hi[TERMS];
            q_terms<TERMS>(__uint_as_float(v[u].x), __uint_as_float(v[u].y),
                           lo);
            q_terms<TERMS>(__uint_as_float(v[u].z), __uint_as_float(v[u].w),
                           hi);
#pragma unroll
            for (int j = 0; j < TERMS; ++j)
              *reinterpret_cast<uint2*>(qs + (j * kQT + r) * qp + c) =
                  make_uint2(lo[j], hi[j]);
          }
        }
      }
      return;
    }
    const int half = ds / 2;
    for (int i = tid; i < kQT * half; i += kMmaThreads) {
      const int r = i / half, c = 2 * (i - r * half);
      const int row = q0 + r, d = d0 + c;
      TQ a = TQ(0), b = TQ(0);
      if (row < Q) {
        const TQ* src = q + (size_t)row * D;
        if (d < D) a = src[d];
        if (d + 1 < D) b = src[d + 1];
      }
      uint32_t w[TERMS];
      q_terms<TERMS>(a, b, w);
#pragma unroll
      for (int j = 0; j < TERMS; ++j)
        *reinterpret_cast<uint32_t*>(qs + (j * kQT + r) * qp + c) = w[j];
    }
  };

  // stage step `it` (key tile it / n_chunks, columns (it % n_chunks) *
  // kMmaBK ..): this warp's kWR key rows of the tile into its own ring,
  // zeros past r1 and D; a step past the last commits an empty group, so
  // the wait counts stay uniform
  auto load_k = [&](int it) {
    if (it < n_steps) {
      const int t = it / n_chunks;
      const int d0 = (it - t * n_chunks) * kMmaBK;
      const int kr0 = r0 + t * kBN + warp * kWR;
      bf16_bits* st = wring + (it % kStages) * kWR * kMmaKP;
      if (vec & 1) {
        constexpr int kC8 = kMmaBK / 8;
        for (int i = lane; i < kWR * kC8; i += 32) {
          const int r = i / kC8, c = i - r * kC8;
          const int row = kr0 + r, d = d0 + c * 8;
          const bool in = row < r1 && d < D;
          ptx::cp_async_16(st + r * kMmaKP + c * 8,
                           keys + (in ? (size_t)row * D + d : 0), in);
        }
      } else {
        for (int i = lane; i < kWR * kMmaBK; i += 32) {
          const int r = i / kMmaBK, c = i - r * kMmaBK;
          const int row = kr0 + r, d = d0 + c;
          st[r * kMmaKP + c] =
              row < r1 && d < D ? keys[(size_t)row * D + d] : bf16_bits(0);
        }
      }
    }
    ptx::cp_async_commit();
  };

  TopK<KM> top[2 * kMT];              // rows m * 16 + lane / 4 + 8 h
#pragma unroll
  for (int i = 0; i < 2 * kMT; ++i) top[i].init();
  float acc[kMT][NT][4];

  for (int it = 0; it < kStages - 1; ++it) load_k(it);
  load_q(0);                          // while the first keys are in flight
  __syncthreads();                    // the queries landed for every warp
  for (int it = 0; it < n_steps; ++it) {
    const int t = it / n_chunks;
    const int c = it - t * n_chunks;
    if (n_slabs > 1 && it > 0 && c % cps == 0) {
      __syncthreads();                // every warp is done with the slab
      load_q(c / cps);
      __syncthreads();
    }
    ptx::cp_async_wait<kStages - 2>();
    __syncwarp();                     // step it landed for the warp; its
    load_k(it + kStages - 1);         // stage (it - 1) % kStages is free
    float part[kMT][NT][4] = {};
    const bf16_bits* ks = wring + (it % kStages) * kWR * kMmaKP;
    const bf16_bits* qc = qs + (c % cps) * kMmaBK;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[kMT][TERMS][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int j = 0; j < TERMS; ++j)
          ptx::ldmatrix_x4(a[m][j], qc + (j * kQT + m * 16 + (lane & 15)) *
                                             qp + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ptx::ldmatrix_x4(bf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                      kMmaKP + kk * 16 +
                                  ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int j = 0; j < TERMS; ++j) {
            ptx::mma_bf16_16816(part[m][2 * np], a[m][j], bf[0], bf[1]);
            ptx::mma_bf16_16816(part[m][2 * np + 1], a[m][j], bf[2],
                                bf[3]);
          }
      }
    }
    if (c == 0) {
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = part[m][n][e];
    } else {
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
    }
    if (c == n_chunks - 1) {
      // fold the tile: acc[m][n][2 h + e] is query m * 16 + lane / 4 + 8 h
      // against key kr + n * 8 + e of the warp's kWR
      const int kr = r0 + t * kBN + warp * kWR + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = kr + n * 8 + e;
          if (r < r1) {
            const bool ok = valid[r];
#pragma unroll
            for (int m = 0; m < kMT; ++m)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                top[2 * m + h].push(ok ? acc[m][n][2 * h + e] : kNeg, r, k);
          }
        }
    }
  }
  ptx::cp_async_wait<0>();
  __syncthreads();                    // ring and q planes are idle now

  // each query's kSrc lists (source warp * 4 + lane % 4), then one warp a
  // query merges them, a list a lane
  constexpr int kSrc = Mma<KM>::kSrc;
  static_assert(kSrc == 32, "one list a lane of the merging warp");
  float* ls = reinterpret_cast<float*>(smem_raw);
  int* li = reinterpret_cast<int*>(ls + kQT * kSrc * KM);
  const int src = warp * 4 + (lane & 3);
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m * 16 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int i = 0; i < KM; ++i) {
        ls[(row * kSrc + src) * KM + i] = top[2 * m + h].s[i];
        li[(row * kSrc + src) * KM + i] = top[2 * m + h].p[i];
      }
    }
  __syncthreads();
  for (int row = warp; row < kQT; row += kMmaWarps) {
    if (q0 + row >= Q) break;         // the whole warp
    TopK<KM> mine;
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      mine.s[i] = ls[(row * kSrc + lane) * KM + i];
      mine.p[i] = li[(row * kSrc + lane) * KM + i];
    }
    const size_t base = ((size_t)(q0 + row) * S + split) * k;
    warp_merge<KM>(mine, lane, k, part_s + base, part_i + base);
  }
}

// One warp per query row: each lane keeps a top-k of its share of the S
// partial lists, then `warp_merge`.
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
  warp_merge<KM>(mine, lane, k, out_s + (size_t)row * k,
                 out_i + (size_t)row * k);
}

constexpr int kMergeThreads = 128;    // 4 query rows per block

template <int KM>
cudaError_t launch_merge(const float* part_s, const int* part_i, int Q,
                         int S, int k, float* out_s, int* out_i,
                         cudaStream_t stream) {
  const int rows_per_block = kMergeThreads / 32;
  cosine_topk_merge_kernel<KM>
      <<<(Q + rows_per_block - 1) / rows_per_block, kMergeThreads, 0,
         stream>>>(part_s, part_i, Q, S, k, out_s, out_i);
  return cudaGetLastError();
}

template <int KM, int TN, bool VEC>
cudaError_t launch_partial(const float* q, const float* keys,
                           const uint8_t* valid, int Q, int N, int D, int k,
                           int S, int rows_per_split, float* part_s,
                           int* part_i, cudaStream_t stream) {
  auto kern = cosine_topk_partial_kernel<KM, TN, VEC>;
  constexpr size_t smem = Tile<TN>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + kBQ - 1) / kBQ, S);
  kern<<<grid, kThreads, smem, stream>>>(q, keys, valid, Q, N, D, k,
                                         rows_per_split, part_s, part_i);
  return cudaGetLastError();
}

template <int KM>
cudaError_t launch_f32(const float* q, const float* keys,
                       const uint8_t* valid, int Q, int N, int D, int k,
                       int vec, int key_tile, int S, int rows_per_split,
                       float* part_s, int* part_i, float* out_s, int* out_i,
                       cudaStream_t stream) {
  cudaError_t err;
  if (key_tile == 32)
    err = vec ? launch_partial<KM, 4, true>(q, keys, valid, Q, N, D, k, S,
                                            rows_per_split, part_s, part_i,
                                            stream)
              : launch_partial<KM, 4, false>(q, keys, valid, Q, N, D, k, S,
                                             rows_per_split, part_s, part_i,
                                             stream);
  else if (key_tile == 64)
    err = vec ? launch_partial<KM, 8, true>(q, keys, valid, Q, N, D, k, S,
                                            rows_per_split, part_s, part_i,
                                            stream)
              : launch_partial<KM, 8, false>(q, keys, valid, Q, N, D, k, S,
                                             rows_per_split, part_s, part_i,
                                             stream);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return launch_merge<KM>(part_s, part_i, Q, S, k, out_s, out_i, stream);
}

// Columns of D a slab of the block's staged queries holds: all of D
// (rounded up to a stage) where it fits beside the ring, else the most
// that fits.
template <int KM, int TERMS>
int slab_columns(int D) {
  const int room = (kSmemMax - kMmaRingBytes) /
                       (2 * TERMS * Mma<KM>::kBQ) -
                   kQPad;
  const int most = room / kMmaBK * kMmaBK;
  const int want = std::max(1, (D + kMmaBK - 1) / kMmaBK) * kMmaBK;
  return std::min(want, most);
}

// The bf16-key launch's arguments, as the C entry takes them.
struct MmaArgs {
  const void* q;
  const void* keys;
  const uint8_t* valid;
  int Q, N, D, k, vec, S, rows_per_split;
  float* part_s;
  int* part_i;
  float* out_s;
  int* out_i;
  cudaStream_t stream;
};

template <int KM, int TERMS, typename TQ>
cudaError_t launch_mma(const MmaArgs& a) {
  auto kern = cosine_topk_mma_kernel<KM, TERMS, TQ>;
  const int ds = slab_columns<KM, TERMS>(a.D);
  const size_t smem = std::max<size_t>(
      kMmaRingBytes + 2 * TERMS * Mma<KM>::kBQ * (ds + kQPad),
      Mma<KM>::kListBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Q + Mma<KM>::kBQ - 1) / Mma<KM>::kBQ, a.S);
  kern<<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const bf16_bits*>(a.keys),
      a.valid, a.Q, a.N, a.D, a.k, a.rows_per_split, ds, a.vec, a.part_s,
      a.part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<KM>(a.part_s, a.part_i, a.Q, a.S, a.k, a.out_s,
                          a.out_i, a.stream);
}

template <int KM>
cudaError_t launch_bf16(const MmaArgs& a, int q_bf16) {
  return q_bf16 ? launch_mma<KM, 1, bf16_bits>(a)
                : launch_mma<KM, kF32Terms, float>(a);
}

}  // namespace

extern "C" {

// Largest k the kernels take (the wrapper refuses more).
int cosine_topk_max_k() { return 16; }

// Query rows per block of the float32-key partial pass (the wrapper sizes
// the splits of N with it and with the key tile it picks, 32 or 64 rows).
int cosine_topk_query_tile() { return kBQ; }

// float32-key blocks resident an SM at this k (the kernel's launch bounds).
int cosine_topk_blocks_per_sm(int k) {
  return k <= 8 ? f32_blocks_per_sm(8) : f32_blocks_per_sm(16);
}

// Query rows a block of the bf16-key kernel takes at this k.
int cosine_topk_mma_query_tile(int k) {
  return k <= 4 ? Mma<4>::kBQ : Mma<16>::kBQ;
}

// Key rows a tile of the bf16-key kernel walks (splits are multiples).
int cosine_topk_mma_key_tile() { return kMmaBN; }

// bf16-key blocks resident an SM (the kernel's launch bounds).
int cosine_topk_mma_blocks_per_sm() { return kMmaBlocksPerSm; }

// float32 q and keys.  Two launches on `stream`: the partial top-k of
// every (query tile, split of rows_per_split key rows, a multiple of
// key_tile) into part_s/part_i (Q * S * k each), then the merge into
// out_s/out_i (Q * k each).  vec: D % 4 == 0 with q and keys 16-byte
// aligned (16-byte copies); else 4-byte copies.  Returns cudaGetLastError()
// after them (0 = launched), or cudaErrorInvalidValue for a key tile other
// than 32 or 64.
int cosine_topk_launch(const float* q, const float* keys,
                       const uint8_t* valid, int Q, int N, int D, int k,
                       int vec, int key_tile, int S, int rows_per_split,
                       float* part_s, int* part_i, float* out_s, int* out_i,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1)
    return launch_f32<1>(q, keys, valid, Q, N, D, k, vec, key_tile, S,
                         rows_per_split, part_s, part_i, out_s, out_i, s);
  if (k <= 4)
    return launch_f32<4>(q, keys, valid, Q, N, D, k, vec, key_tile, S,
                         rows_per_split, part_s, part_i, out_s, out_i, s);
  if (k <= 8)
    return launch_f32<8>(q, keys, valid, Q, N, D, k, vec, key_tile, S,
                         rows_per_split, part_s, part_i, out_s, out_i, s);
  return launch_f32<16>(q, keys, valid, Q, N, D, k, vec, key_tile, S,
                        rows_per_split, part_s, part_i, out_s, out_i, s);
}

// bf16 keys; q bf16 (q_bf16 = 1) or float32.  The same two launches, the
// splits of N a multiple of cosine_topk_mma_key_tile() rows each and the
// query tiles cosine_topk_mma_query_tile(k) rows.  vec bit 0: D % 8 == 0
// and keys 16-byte aligned (16-byte copies), else element-wise; bit 1: D a
// multiple of 16 bytes of q's values and q 16-byte aligned (16-byte q
// loads), else in pairs.
int cosine_topk_mma_launch(const void* q, const void* keys,
                           const uint8_t* valid, int Q, int N, int D, int k,
                           int q_bf16, int vec, int S,
                           int rows_per_split, float* part_s, int* part_i,
                           float* out_s, int* out_i, void* stream) {
  const MmaArgs a{q, keys, valid, Q, N, D, k, vec, S, rows_per_split,
                  part_s, part_i, out_s, out_i,
                  static_cast<cudaStream_t>(stream)};
  if (k <= 1) return launch_bf16<1>(a, q_bf16);
  if (k <= 4) return launch_bf16<4>(a, q_bf16);
  if (k <= 8) return launch_bf16<8>(a, q_bf16);
  return launch_bf16<16>(a, q_bf16);
}

}  // extern "C"
