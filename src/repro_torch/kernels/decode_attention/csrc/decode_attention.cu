// Single-token GQA decode attention against a KV cache, for Hopper (sm_90a):
// split-L flash-decoding.
//
// Replaces the TPU Pallas kernel repro/kernels/decode_attention/kernel.py::
// decode_attention (body `_kernel`): one query token per (batch row, query
// head) against a (B, L, KV, hd) cache under a (B, L) validity mask, query
// head h reading KV head h / (H / KV), softmax over the cache in float32 and
// the output in the query's dtype.  Scores are (q * scale) . k; scale
// defaults to hd^-0.5 in the wrapper (the decoder scales q in its compute
// dtype itself and passes 1).  Masked slots score -1e30, as in the plain
// version ../ref.py, so a row whose every slot is masked averages v over the
// L real slots (the Pallas kernel also weighs in its padding there).
//
// Bound.  Decode reads the whole cache once and does 4 hd flops per (query
// head, slot): at G = H / KV = 1 (Phi-3-mini) that is 1 flop per bf16 byte,
// and at G = 32 (MQA) still far below the card's ~295, so device-memory
// bytes bound every shape.  Reaching them takes many CTAs with many bytes in
// flight; the TPU design (the cache streamed through VMEM along a sequential
// grid axis, (m, l, acc) carried in scratch) maps to one serial loop per
// (b, kv head), which at B * KV = 8 (GQA at batch 1, MQA at batch 8) leaves
// 124 of 132 SMs idle.
//
// Design.  The grid is (units, S): L is cut into S chunks of `rows` cache
// rows (a whole number of 64-row tiles, chosen by the wrapper so that the
// grid fills the card; S = 1 when the units alone do, as at Phi-3-mini's
// decode step).  Each CTA runs the online softmax over its chunk and, when
// S > 1, writes float32 partials (m, l, acc[hd]) per query head; a second
// launch merges the S partials of each query head (rescale by 2^(m - M),
// sum, divide) and writes the output.  With S = 1 the CTA writes the output
// itself: one launch.  Scores are kept in base 2 (log2(e) folded into the
// scale; the masked score stays -1e30, so a fully masked row still weighs
// every slot equally in every split and in the merge).  K and V tiles of 64
// rows stream into shared memory with 16-byte cp.async copies, double
// buffered (tile t + 1 in flight while tile t is used), rows past the chunk
// zero-filled and scored -inf; rows are padded to an odd count of 16-byte
// chunks so row-parallel reads are free of bank conflicts.  Four warps each
// own 16 rows of every tile and keep their own (m, l, acc) in registers;
// the warps combine once, at the end of the chunk, through shared memory.
//
//   * Row kernel (float32, and bf16 with G < 4): a unit is one (b, query
//     head); the G heads of a group are G CTAs, which read their KV head's
//     rows through L2.  Two lanes score one row (each half of hd, 16-byte
//     shared loads, one shuffle to join), so a warp scores its 16 rows at
//     once; max and sum reduce over 16 lanes once per tile; each lane then
//     folds the 16 rows into its hd / 32 output columns (FMA).
//   * MMA kernel (bf16, G >= 4): a unit is one (b, kv head, 16 query heads
//     of its group): the group's query heads are the rows of mma.sync
//     m16n8k16 products (bf16 in, float32 accumulate), padded to 16 with
//     zero rows, for S = q K^T and O += P V alike.  q's fragments stay in
//     registers across the chunk; P stays in registers (the m16n8
//     accumulator layout is the next product's A layout, as in the flash
//     kernel), rounded to bf16 there.
//
// A chunk with a valid slot reads no masked row (zero-filled: its weight is
// exactly 0 there), so a ring or a window reads only its live slots; a
// chunk with none reads every row, for the fully masked row's average.
// The merge is one block per query head, a thread per column.  Nothing is
// atomic: every sum runs in a fixed order, so a call is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;                    // cache rows per tile
constexpr int kWarpRows = kTile / kWarps;    // 16 rows per warp and tile
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// acc + <16 bytes of row, the matching floats of q>
__device__ __forceinline__ float dot16(const float* row, const float* qv,
                                       float acc) {
  const float4 a = *reinterpret_cast<const float4*>(row);
  const float4 b = *reinterpret_cast<const float4*>(qv);
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* row,
                                       const float* qv, float acc) {
  // a bf16 is the high half of the float32 with the same bits
  const uint4 raw = *reinterpret_cast<const uint4*>(row);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(w[i] << 16), qv[2 * i], acc);
    acc = fmaf(__uint_as_float(w[i] & 0xffff0000u), qv[2 * i + 1], acc);
  }
  return acc;
}

// reductions over the 16 lanes of a half warp (lanes differ in bits 0-3)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Where a CTA's result goes: S == 1 writes the output (part_m null), else
// the float32 partials of query head u (= b * H + h) in split s at u * S + s.
struct Partials {
  float* m;
  float* l;
  float* acc;
};

// Stage the K and V rows [t0, t0 + kTile) of one kv head into `kd`, `vd`
// (pitch P elements); rows at or past r1 are zero-filled, and so are
// masked rows when `skip_masked` (their weight is then exactly 0).
template <typename T, int HD, int P>
__device__ __forceinline__ void stage_tile(T* kd, T* vd, const T* k,
                                           const T* v, size_t row0_off,
                                           size_t row_stride, int t0, int r1,
                                           const uint8_t* valb,
                                           bool skip_masked, int tid) {
  constexpr int E = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int C = HD / E;
  for (int i = tid; i < kTile * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    const bool in = t0 + r < r1 && (!skip_masked || valb[t0 + r]);
    const size_t off = in ? row0_off + (size_t)(t0 + r) * row_stride : 0;
    ptx::cp_async_16(kd + r * P + c * E, k + off + c * E, in);
    ptx::cp_async_16(vd + r * P + c * E, v + off + c * E, in);
  }
  ptx::cp_async_commit();
}

// Whether any slot of the chunk [r0, r1) is valid (block-wide; every
// thread of the block calls it).  Then the chunk's maximum score is a
// valid slot's, every masked slot's weight 2^(-1e30 - max) is exactly 0
// and its K and V rows need not be read.  A chunk with no valid slot
// reads them all: if its row has no valid slot anywhere, the output is
// the average of v over all L slots.
__device__ __forceinline__ bool chunk_has_valid(const uint8_t* valb, int r0,
                                                int r1, int tid) {
  int any = 0;
  for (int r = r0 + tid; r < r1; r += kThreads) any |= valb[r];
  return __syncthreads_or(any) != 0;
}

template <typename T, int HD>
__host__ __device__ constexpr int row_pitch() {
  return HD + 16 / (int)sizeof(T);           // one 16-byte chunk of pad
}

template <typename T, int HD>
size_t rows_smem_bytes() {
  return sizeof(float) * HD +
         sizeof(T) * 4 * (size_t)kTile * row_pitch<T, HD>();
}

// ---------------------------------------------------------------------------
// row kernel: one (b, query head) per unit, FMA
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
decode_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ valid,
                   T* __restrict__ out, int H, int KV, int L, int rows,
                   float scale_log2, Partials part) {
  constexpr int E = 16 / sizeof(T);
  constexpr int C = HD / E;                  // chunks per row (even)
  constexpr int P = row_pitch<T, HD>();
  constexpr int NJ = HD / 32;                // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);          // HD, scaled
  T* ks = reinterpret_cast<T*>(qs + HD);                   // 2 x kTile x P
  T* vs = ks + 2 * kTile * P;

  const int unit = blockIdx.x;               // b * H + h
  const int b = unit / H;
  const int kvh = (unit - b * H) / (H / KV);
  const int S = gridDim.y;
  const int split = blockIdx.y;
  const int r0 = split * rows;
  const int r1 = min(L, r0 + rows);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row_stride = (size_t)KV * HD;
  const size_t base = (size_t)b * L * row_stride + (size_t)kvh * HD;
  const uint8_t* valb = valid + (size_t)b * L;
  const int n_tiles = (r1 - r0 + kTile - 1) / kTile;

  const bool skip = chunk_has_valid(valb, r0, r1, tid);
  stage_tile<T, HD, P>(ks, vs, k, v, base, row_stride, r0, r1, valb, skip,
                       tid);
  for (int d = tid; d < HD; d += kThreads)
    qs[d] = to_f(q[(size_t)unit * HD + d]) * scale_log2;

  const int rr = lane & 15;                  // the row this lane scores
  const int half = lane >> 4;                // and which half of hd
  float m = -CUDART_INF_F, l = 0.f, acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage_tile<T, HD, P>(ks + ((it + 1) & 1) * kTile * P,
                           vs + ((it + 1) & 1) * kTile * P, k, v, base,
                           row_stride, r0 + (it + 1) * kTile, r1, valb,
                           skip, tid);
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();                         // tile it (and q) landed
    const int row0 = r0 + it * kTile + warp * kWarpRows;
    if (row0 < r1) {                         // warp-uniform
      const T* kt = ks + (it & 1) * kTile * P + warp * kWarpRows * P;
      const T* vt = vs + (it & 1) * kTile * P + warp * kWarpRows * P;
      const T* kr = kt + rr * P + half * (HD / 2);
      const float* qh = qs + half * (HD / 2);
      float sc = 0.f;
#pragma unroll
      for (int c = 0; c < C / 2; ++c) sc = dot16(kr + c * E, qh + c * E, sc);
      sc += __shfl_xor_sync(0xffffffffu, sc, 16);
      const int row = row0 + rr;
      sc = row >= r1 ? -CUDART_INF_F : valb[row] ? sc : kNeg;
      // row0 is in range, so m_new is finite
      const float m_new = fmaxf(m, half_max(sc));
      const float alpha = exp2f(m - m_new);
      const float p = exp2f(sc - m_new);
      l = l * alpha + half_sum(p);
      m = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] *= alpha;
#pragma unroll
      for (int t = 0; t < kWarpRows; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
        const T* vr = vt + t * P + lane;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[j] = fmaf(pt, to_f(vr[32 * j]), acc[j]);
      }
    }
    __syncthreads();                         // stage it & 1 is free again
  }

  // the warps' (m, l, acc) meet in the idle stage buffers
  float* cm = reinterpret_cast<float*>(ks);  // kWarps
  float* cl = cm + kWarps;                   // kWarps
  float* ca = cl + kWarps;                   // kWarps x HD
  if (lane == 0) {
    cm[warp] = m;
    cl[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) ca[warp * HD + lane + 32 * j] = acc[j];
  __syncthreads();
  float M = cm[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) M = fmaxf(M, cm[w]);
  for (int d = tid; d < HD; d += kThreads) {
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(cm[w] - M);     // a warp with no row: 0
      ls = fmaf(f, cl[w], ls);
      a = fmaf(f, ca[w * HD + d], a);
    }
    if (part.m == nullptr) {
      out[(size_t)unit * HD + d] = from_f<T>(a / fmaxf(ls, 1e-30f));
    } else {
      const size_t pi = (size_t)unit * S + split;
      if (d == 0) {
        part.m[pi] = M;
        part.l[pi] = ls;
      }
      part.acc[pi * HD + d] = a;
    }
  }
}

// ---------------------------------------------------------------------------
// MMA kernel: bf16, one (b, kv head, 16 query heads of its group) per unit
// ---------------------------------------------------------------------------

template <int HD>
size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(HD + 8) * (16 + 4 * kTile);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const uint8_t* __restrict__ valid,
                  __nv_bfloat16* __restrict__ out, int H, int KV, int L,
                  int rows, float scale_log2, Partials part) {
  constexpr int P = HD + 8;                  // row pitch (elements)
  constexpr int C = HD / 8;                  // 16-byte chunks per row
  constexpr int KS = HD / 16;                // k-steps of q K^T
  constexpr int NO = HD / 8;                 // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 16 x P
  __nv_bfloat16* ks = qs + 16 * P;           // 2 x kTile x P
  __nv_bfloat16* vs = ks + 2 * kTile * P;

  const int G = H / KV;
  const int MT = (G + 15) / 16;              // 16-head tiles per group
  const int unit = blockIdx.x;
  const int b = unit / (KV * MT);
  const int rem = unit - b * KV * MT;
  const int kvh = rem / MT;
  const int h0 = kvh * G + (rem - kvh * MT) * 16;   // first head of the tile
  const int nh = min(16, kvh * G + G - h0);         // heads in the tile
  const int S = gridDim.y;
  const int split = blockIdx.y;
  const int r0 = split * rows;
  const int r1 = min(L, r0 + rows);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                   // fragment row (and row + 8)
  const int c2 = 2 * (lane & 3);             // fragment column pair
  const size_t row_stride = (size_t)KV * HD;
  const size_t base = (size_t)b * L * row_stride + (size_t)kvh * HD;
  const uint8_t* valb = valid + (size_t)b * L;
  const int n_tiles = (r1 - r0 + kTile - 1) / kTile;

  // the tile's query heads as mma rows, zero rows past the group
  for (int i = tid; i < 16 * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    const bool in = r < nh;
    ptx::cp_async_16(qs + r * P + c * 8,
                     q + (in ? ((size_t)b * H + h0 + r) * HD : 0) + c * 8,
                     in);
  }
  const bool skip = chunk_has_valid(valb, r0, r1, tid);
  stage_tile<__nv_bfloat16, HD, P>(ks, vs, k, v, base, row_stride, r0, r1,
                                   valb, skip, tid);

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};                   // this thread's share
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[KS][4];

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage_tile<__nv_bfloat16, HD, P>(
          ks + ((it + 1) & 1) * kTile * P, vs + ((it + 1) & 1) * kTile * P,
          k, v, base, row_stride, r0 + (it + 1) * kTile, r1, valb, skip,
          tid);
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();                         // tile it (and q) landed
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ptx::ldmatrix_x4(qf[kk], qs + (lane & 15) * P + kk * 16 +
                                     (lane >> 4) * 8);
    }
    const int row0 = r0 + it * kTile + warp * kWarpRows;
    if (row0 < r1) {                         // warp-uniform
      const __nv_bfloat16* kt = ks + (it & 1) * kTile * P +
                                warp * kWarpRows * P;
      const __nv_bfloat16* vt = vs + (it & 1) * kTile * P +
                                warp * kWarpRows * P;
      // S = q K^T: 16 heads x this warp's 16 cache rows (2 n-tiles)
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bf[4];
        ptx::ldmatrix_x4(bf, kt + ((lane & 7) + (lane >> 4) * 8) * P +
                                 kk * 16 + ((lane >> 3) & 1) * 8);
        ptx::mma_bf16_16816(s[0], qf[kk], bf[0], bf[1]);
        ptx::mma_bf16_16816(s[1], qf[kk], bf[2], bf[3]);
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + n * 8 + c2 + (e & 1);
          const float x = row >= r1 ? -CUDART_INF_F
                          : valb[row] ? s[n][e] * scale_log2
                                      : kNeg;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);             // finite: row0 is in range
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - m[e >> 1]);
          l[e >> 1] += s[n][e];
        }
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      // O += P V: P's accumulator fragments are the A fragment, in bf16
      const uint32_t a[4] = {ptx::pack_bf16x2(s[0][0], s[0][1]),
                             ptx::pack_bf16x2(s[0][2], s[0][3]),
                             ptx::pack_bf16x2(s[1][0], s[1][1]),
                             ptx::pack_bf16x2(s[1][2], s[1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bf[4];
        ptx::ldmatrix_x4_trans(
            bf, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + np * 16 +
                    (lane >> 4) * 8);
        ptx::mma_bf16_16816(acc[2 * np], a, bf[0], bf[1]);
        ptx::mma_bf16_16816(acc[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();                         // stage it & 1 is free again
  }

  // the warps' (m, l, acc) per head meet in the idle stage buffers
  float* cm = reinterpret_cast<float*>(ks);  // kWarps x 16
  float* cl = cm + kWarps * 16;              // kWarps x 16
  float* ca = cl + kWarps * 16;              // kWarps x 16 x HD
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    if ((lane & 3) == 0) {
      cm[warp * 16 + g + 8 * r] = m[r];
      cl[warp * 16 + g + 8 * r] = lr;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float* dst = ca + (size_t)(warp * 16 + g + 8 * r) * HD + n * 8 + c2;
      dst[0] = acc[n][2 * r];
      dst[1] = acc[n][2 * r + 1];
    }
  }
  __syncthreads();
  for (int i = tid; i < nh * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    float M = cm[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, cm[w * 16 + r]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(cm[w * 16 + r] - M);
      ls = fmaf(f, cl[w * 16 + r], ls);
      a = fmaf(f, ca[(size_t)(w * 16 + r) * HD + d], a);
    }
    const size_t u = (size_t)b * H + h0 + r;
    if (part.m == nullptr) {
      out[u * HD + d] = __float2bfloat16(a / fmaxf(ls, 1e-30f));
    } else {
      const size_t pi = u * S + split;
      if (d == 0) {
        part.m[pi] = M;
        part.l[pi] = ls;
      }
      part.acc[pi * HD + d] = a;
    }
  }
}

// ---------------------------------------------------------------------------
// merge of the S partials: one block per query head, a thread per column
// ---------------------------------------------------------------------------

template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ pm,
                                    const float* __restrict__ pl,
                                    const float* __restrict__ pa,
                                    T* __restrict__ out, int S) {
  extern __shared__ float w[];               // S weights 2^(m_s - M)
  __shared__ float inv;
  const int u = blockIdx.x;
  const int hd = blockDim.x;
  const int d = threadIdx.x;
  const float* mu = pm + (size_t)u * S;
  float M = -CUDART_INF_F;
  for (int s = 0; s < S; ++s) M = fmaxf(M, mu[s]);
  for (int s = d; s < S; s += hd) w[s] = exp2f(mu[s] - M);
  __syncthreads();
  if (d == 0) {
    float ls = 0.f;
    for (int s = 0; s < S; ++s) ls = fmaf(w[s], pl[(size_t)u * S + s], ls);
    inv = 1.f / fmaxf(ls, 1e-30f);
  }
  __syncthreads();
  const float* au = pa + (size_t)u * S * hd + d;
  float a = 0.f;
#pragma unroll 8
  for (int s = 0; s < S; ++s) a = fmaf(w[s], au[(size_t)s * hd], a);
  out[(size_t)u * hd + d] = from_f<T>(a * inv);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Opt a kernel in to more than the default 48 KB of dynamic shared memory.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           void* out, int B, int H, int KV, int L, float scale, int mma,
           int S, int rows, Partials part, cudaStream_t stream) {
  const float scale_log2 = scale * kLog2e;
  const Partials direct{nullptr, nullptr, nullptr};
  const Partials where = S > 1 ? part : direct;
  cudaError_t e;
  if (mma) {
    if constexpr (sizeof(T) == 2) {
      const size_t smem = mma_smem_bytes<HD>();
      auto kern = decode_mma_kernel<HD>;
      e = allow_smem(kern, smem);
      if (e != cudaSuccess) return (int)e;
      const int G = H / KV;
      const dim3 grid(B * KV * ((G + 15) / 16), S);
      kern<<<grid, kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), valid,
          static_cast<__nv_bfloat16*>(out), H, KV, L, rows, scale_log2,
          where);
    } else {
      return (int)cudaErrorInvalidValue;     // the mma kernel is bf16 only
    }
  } else {
    const size_t smem = rows_smem_bytes<T, HD>();
    auto kern = decode_rows_kernel<T, HD>;
    e = allow_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(B * H, S);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), valid, static_cast<T*>(out), H, KV, L,
        rows, scale_log2, where);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  decode_merge_kernel<T><<<B * H, HD, sizeof(float) * S, stream>>>(
      part.m, part.l, part.acc, static_cast<T*>(out), S);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v,
             const uint8_t* valid, void* out, int B, int H, int KV, int L,
             int hd, float scale, int mma, int S, int rows, Partials part,
             cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, valid, out, B, H, KV, L, scale, mma, S,
                           rows, part, s);
    case 64:
      return launch<T, 64>(q, k, v, valid, out, B, H, KV, L, scale, mma, S,
                           rows, part, s);
    case 96:
      return launch<T, 96>(q, k, v, valid, out, B, H, KV, L, scale, mma, S,
                           rows, part, s);
    case 128:
      return launch<T, 128>(q, k, v, valid, out, B, H, KV, L, scale, mma, S,
                            rows, part, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One call on `stream`: q (B, H, hd), k and v (B, L, KV, hd), all
// contiguous of one dtype (0 = float32, 1 = bfloat16) and 16-byte aligned;
// valid (B, L) bytes; out (B, H, hd) of q's dtype.  mma = 1 takes the
// tensor-core kernel (bf16 only).  L is cut into S splits of `rows` rows
// (a multiple of the 64-row tile, else cudaErrorInvalidValue);
// with S > 1 the partials go to part_m, part_l (B * H * S floats each) and
// part_acc (B * H * S * hd) and a second launch merges them, with S = 1 the
// partials may be NULL and there is one launch.  Returns cudaGetLastError()
// after the launches (0 = launched), or cudaErrorInvalidValue for an hd,
// dtype or kernel it lacks.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const uint8_t* valid, void* out, int B, int H,
                            int KV, int L, int hd, int dtype, float scale,
                            int mma, int S, int rows, float* part_m,
                            float* part_l, float* part_acc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Partials part{part_m, part_l, part_acc};
  if (S < 1 || rows < 1 || rows % kTile || (S > 1 && part_m == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, valid, out, B, H, KV, L, hd, scale, mma,
                           S, rows, part, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, valid, out, B, H, KV, L, hd,
                                   scale, mma, S, rows, part, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
