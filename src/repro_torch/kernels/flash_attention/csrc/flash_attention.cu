// Blocked online-softmax attention (prefill / full sequence), for Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (body `_kernel`): softmax((q * scale) k^T) v per (batch
// row, query head), GQA by reading KV head h / (H / KV), with positional
// masks on implicit positions (query row i and key row j are positions i
// and j): causal (j <= i), a sliding window (i - j < W, and j - i < W when
// not causal) or none.  scale defaults to hd^-0.5 in the wrapper (the
// decoder scales q in its compute dtype itself and passes 1).  Masked
// scores are -1e30.  The (Sq x Skv) score matrix never exists in device
// memory.  Two kernels, chosen by dtype (never after a failure), each with
// a bf16-accumulate twin (below):
//
// bfloat16: tensor cores (FlashAttention-2 on mma.sync).  A block of W
// warps (W = 2 when Sq <= 32, else 4: the launch picks it) holds 16 W query
// rows of one (b, h); each warp owns 16 rows.  q's tile comes into shared
// memory once and its A fragments (ldmatrix.x4) stay in registers across
// the KV loop.  K and V tiles of 64 rows stream in with 16-byte cp.async
// copies, double-buffered (tile t+1 in flight while tile t is multiplied),
// rows past Skv zero-filled.  Rows are bf16 with a 16-byte pad (an odd
// count of 16-byte chunks per row at hd = 32..128), so every ldmatrix is
// free of bank conflicts.  S = q k^T is mma.sync m16n8k16 (bf16 in,
// float32 accumulate) with K's row-major tile as the column-major B
// operand; `scale` multiplies the float32 scores (q cannot be scaled
// first: it is rounded to bf16 before the product).  The online softmax
// runs on the accumulator fragments (a thread holds two rows; row max and
// sum reduce over the 4-lane quad), in base 2 with log2(e) folded into the
// scale.  P is rounded to bf16 in registers: the m16n8 accumulator layout
// is the A layout of the next m16n8k16, so P never touches shared memory;
// P V runs on the same mma with V's fragments from ldmatrix.x4.trans.  Each
// weight is within 2^-9 relative of the float32 one, so an output moves by
// at most ~2^-9 max|v|; row sums and the output accumulate in float32.
// Masks are evaluated only on tiles where some (row, key) pair of the
// block is out of reach, and the query tiles with the longest causal
// reach are scheduled first, so the short ones fill the card's tail.
//
// float32: FMA, no tensor cores (TF32 would miss the decoder's float32
// check against forward_lm).  One block per (b, h, 64-row
// q tile) stages its q tile (float32, scaled, transposed), each K tile
// (float32, transposed) and V tile in shared memory; 256 threads as 16 x 16
// each own a 4 x 4 patch of the tile's scores (a register-tiled outer
// product over hd), reduce row max and sum over 16-lane groups, write the
// weights back to shared memory and fold them into a 4-row x hd/16-column
// slice of the float32 accumulator in registers.
//
// bf16-accumulate mode (the config's attn_f32=False; the reference model's
// gqa_attention with acc_dtype=bfloat16), one kernel of its own per dtype,
// chosen by the launch's acc_bf16.  Logits, row max and denominator stay
// float32; weights and PV sums are bf16 where the reference rounds them:
// dense (kv_chunk == 0) the normalised weights exp(s - m) / l are rounded
// once and the output is the float32 sum of w bf16(v) rounded once to
// bf16; chunked (kv_chunk > 0, chunks aligned to key 0) each chunk's
// weights exp(s - m_new) are rounded, l sums them as rounded, and acc =
// bf16(bf16(acc bf16(alpha)) + bf16(chunk's float32 P V sum)), the output
// acc / l.  Both need a row's max (dense: and sum) over the chunk before
// its first weight, so each chunk is taken in two phases: statistics,
// then weights and P V.  The bf16 kernel (below) has two routes, chosen on
// the host from the shape (kernel.py `acc_bf16_route`): one walk (dense
// only) keeps every tile's float32 values in shared memory from the first
// phase to the second, so K and V are each copied once and q k^T runs
// once; two walks copy K again beside V and run q k^T again.  A kept tile
// costs 4 KB a warp (16 rows x 64 keys x 4 bytes), so one walk over a
// reference chunk (1024 keys, 64 KB a warp) leaves room for 2 warps on an
// SM; on an H100 it ran several times slower than two walks at 8-12
// warps, and over 5 tiles (288 keys) mostly slower too, while over 1-3
// tiles it was faster (PERF.md).  The host takes one walk for a dense
// reach of up to 3 tiles (the decoders' 32-token prefills) and two walks
// past that and for every chunked launch.  Dense and chunked are separate
// instantiations, each holding only its own accumulators.  Chunks (and tiles) outside a block's causal or window
// reach are skipped: the reference's fully masked leading chunks are
// wiped by alpha = 0 and its trailing ones leave (m, l, acc) as they are.
// The float32 kernel walks each chunk twice the same way (FMA; the
// config's float32 inputs only reach it in a float32 model).
//
// Both: on the TPU the KV blocks are a sequential grid axis with (m, l,
// acc) carried in VMEM scratch and fully masked blocks skipped with
// @pl.when; here a loop inside the block walks the KV tiles inside the
// causal and window reach only (the skip becomes the loop's bounds).  Any
// (b, h, s) strides: the wrapper hands the model's (B, S, H, hd) tensors
// over as (B, H, S, hd) views, so no transpose is copied (bf16 needs them
// 16-byte aligned, which the wrapper checks).
//
// Bound.  4 hd flops per live (query, key) pair against each of q, k, v, o
// read or written once: at hd = 96 and a few hundred positions that is
// above the card's bytes-to-flops balance, so the bf16 tensor-core rate
// (989 TFLOP/s dense) bounds long sequences; at the decoder's prefill (S =
// 32) bytes and launch latency do.  This kernel reaches about a fifth of
// that rate at S = 2048: mma.sync is issued a warp at a time from
// registers, and every 64-row query tile re-reads its head's K and V from
// L2 (wgmma with TMA-fed tiles and a producer warp is the step beyond);
// the float32 kernel is capped at the 67 TFLOP/s FMA rate.  The bf16
// mode's two walks run q k^T twice (6 hd flops a pair where the bound
// counts 4) and read K twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // key rows per tile
constexpr int kThreads = 256;         // 16 x 16, a 4 x 4 patch each
constexpr int kLd = kBQ + 4;          // row pitch of the transposed tiles
constexpr float kNeg = -1e30f;

static_assert(kBQ == kBK, "the transposed tiles share one pitch");

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// reductions over the 16 lanes of one row group (lanes differ in bits 0-3)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * (2 * (size_t)hd * kLd + (size_t)kBK * hd +
                          (size_t)kBK * kLd);
}

struct Strides {
  long long b, h, s;                  // elements; the hd axis has stride 1
};

// Helpers of the bf16-accumulate kernels (below).  The float32-accumulate
// kernels keep their own inline copies of the same steps: built from
// these helpers, the FMA kernel ran 12-15 % slower at hd = 128 on the
// H100 (both timed in one run).

// a (row, key) pair in reach: the key before `lim` (the end of Skv or of
// the key's chunk) and inside the causal and window masks
__device__ __forceinline__ bool in_reach(int row, int col, int lim,
                                         int causal, int window) {
  bool ok = col < lim;
  if (causal) ok = ok && col <= row;
  if (window > 0) {
    ok = ok && row - col < window;
    if (!causal) ok = ok && col - row < window;
  }
  return ok;
}

// ---------------------------------------------------------------------------
// float32: FMA
// ---------------------------------------------------------------------------

// s = q k^T for this thread's 4 x 4 patch of a tile (rows q0 + 4 ty + i,
// keys k0 + 4 tx + j; q^T and k^T staged in shared memory), the pairs
// out of reach set to kNeg
template <int HD>
__device__ __forceinline__ void fma_scores(const float* qs, const float* ks,
                                           int q0, int k0, int lim, int ty,
                                           int tx, int causal, int window,
                                           float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(qs + d * kLd + ty * 4);
    const float4 c = *reinterpret_cast<const float4*>(ks + d * kLd + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[i][j] = in_reach(q0 + ty * 4 + i, k0 + tx * 4 + j, lim, causal,
                         window)
                    ? s[i][j]
                    : kNeg;
}

// acc += P V for this thread's 4 rows x HD/16 columns (P^T and V staged
// in shared memory)
template <int HD>
__device__ __forceinline__ void fma_pv(const float* ps, const float* vs,
                                       int ty, int tx,
                                       float (&acc)[4][HD / 16]) {
#pragma unroll 4
  for (int t = 0; t < kBK; ++t) {
    const float4 p = *reinterpret_cast<const float4*>(ps + t * kLd + ty * 4);
    const float* vr = vs + t * HD + tx;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const float x = vr[16 * c];
      acc[0][c] = fmaf(p.x, x, acc[0][c]);
      acc[1][c] = fmaf(p.y, x, acc[1][c]);
      acc[2][c] = fmaf(p.z, x, acc[2][c]);
      acc[3][c] = fmaf(p.w, x, acc[3][c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KV, int Sq, int Skv, Strides qst, Strides kst,
                       Strides vst, Strides ost, int causal, int window,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kCols = HD / 16;      // accumulator columns per thread
  float* qs = smem;                   // HD x kLd: q^T, scaled
  float* ks = qs + HD * kLd;          // HD x kLd: k^T
  float* vs = ks + HD * kLd;          // kBK x HD
  float* ps = vs + kBK * HD;          // kBK x kLd: weights^T

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;            // key cols tx*4.., acc cols tx+16c
  const int ty = tid >> 4;            // query rows ty*4..
  const T* qb = q + b * qst.b + h * qst.h;
  const T* kb = k + b * kst.b + kvh * kst.h;
  const T* vb = v + b * vst.b + kvh * vst.h;
  T* ob = o + b * ost.b + h * ost.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    qs[d * kLd + r] =
        q0 + r < Sq ? to_f(qb[(q0 + r) * qst.s + d]) * scale : 0.f;
  }

  // the keys some row of this tile can reach
  const int q_last = min(Sq, q0 + kBQ) - 1;
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (window > 0) {
    k_lo = max(0, q0 - window + 1);
    if (!causal) k_hi = min(k_hi, q_last + window);
  }
  k_lo = (k_lo / kBK) * kBK;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();                  // the last tile's readers are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      const bool in = k0 + r < Skv;
      ks[d * kLd + r] = in ? to_f(kb[(k0 + r) * kst.s + d]) : 0.f;
      vs[r * HD + d] = in ? to_f(vb[(k0 + r) * vst.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qs + d * kLd + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(ks + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        bool ok = col < Skv;
        if (causal) ok = ok && col <= row;
        if (window > 0) {
          ok = ok && row - col < window;
          if (!causal) ok = ok && col - row < window;
        }
        s[i][j] = ok ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(tx * 4 + j) * kLd + ty * 4 + i] = p;
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      const float4 p = *reinterpret_cast<const float4*>(ps + t * kLd + ty * 4);
      const float* vr = vs + t * HD + tx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float x = vr[16 * c];
        acc[0][c] = fmaf(p.x, x, acc[0][c]);
        acc[1][c] = fmaf(p.y, x, acc[1][c]);
        acc[2][c] = fmaf(p.z, x, acc[2][c]);
        acc[3][c] = fmaf(p.w, x, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < Sq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        ob[row * ost.s + tx + 16 * c] = from_f<T>(acc[i][c] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync
// ---------------------------------------------------------------------------

constexpr int kTK = 64;               // key rows per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// q tile, then two stages of K and V tiles; rows of hd + 8 bf16 (a 16-byte
// pad)
template <int HD, int W>
size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(HD + 8) * (16 * W + 4 * kTK);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// whether some (row, key) pair of the block on the tile at k0 is out of
// reach (rows q0..q_last; keys at or past `lim` are)
__device__ __forceinline__ bool tile_edge(int k0, int lim, int q0,
                                          int q_last, int causal,
                                          int window) {
  const int k1 = k0 + kTK - 1;
  return k1 >= lim || (causal && k1 > q0) ||
         (window > 0 && (q_last - k0 >= window ||
                         (!causal && k1 - q0 >= window)));
}

// S = q k^T for a warp's 16 query rows against the kTK-key tile at k0 (8
// n-tiles of 8 keys; K's row-major tile is the column-major B operand),
// scaled to base 2, the pairs out of reach set to kNeg on an edge tile
// (this thread's rows row0 and row0 + 8), each row's max folded into mx
template <int HD>
__device__ __forceinline__ void mma_scores(
    const uint32_t (&qf)[HD / 16][4], const __nv_bfloat16* kt, int lane,
    float scale_log2, bool edge, int row0, int k0, int lim, int causal,
    int window, float (&s)[8][4], float (&mx)[2]) {
  constexpr int P = HD + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ptx::ldmatrix_x4(bf, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                    P + kk * 16 + ((lane >> 3) & 1) * 8);
      ptx::mma_bf16_16816(s[2 * np], qf[kk], bf[0], bf[1]);
      ptx::mma_bf16_16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
    }
  }
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * scale_log2;
      if (edge && !in_reach(row0 + (e >> 1) * 8, k0 + n * 8 + c2 + (e & 1),
                            lim, causal, window))
        x = kNeg;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
}

// acc += P V for a warp's 16 rows: P's accumulator fragments, rounded to
// bf16, are the A fragments of the next m16n8k16 (P never touches shared
// memory); V's fragments from ldmatrix.x4.trans
template <int HD>
__device__ __forceinline__ void mma_pv(const float (&p)[8][4],
                                       const __nv_bfloat16* vt, int lane,
                                       float (&acc)[HD / 8][4]) {
  constexpr int P = HD + 8;
#pragma unroll
  for (int kk = 0; kk < kTK / 16; ++kk) {
    const uint32_t a[4] = {
        ptx::pack_bf16x2(p[2 * kk][0], p[2 * kk][1]),
        ptx::pack_bf16x2(p[2 * kk][2], p[2 * kk][3]),
        ptx::pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        ptx::pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t bf[4];
      ptx::ldmatrix_x4_trans(
          bf, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                  np * 16 + (lane >> 4) * 8);
      ptx::mma_bf16_16816(acc[2 * np], a, bf[0], bf[1]);
      ptx::mma_bf16_16816(acc[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

template <int HD, int W>
__global__ void __launch_bounds__(W * 32)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int H, int KV,
                            int Sq, int Skv, Strides qst, Strides kst,
                            Strides vst, Strides ost, int causal, int window,
                            float scale_log2) {
  constexpr int P = HD + 8;           // row pitch (elements)
  constexpr int BQ = 16 * W;          // query rows per block
  constexpr int kChunks = HD / 8;     // 16-byte chunks per row
  constexpr int kThreadsB = W * 32;
  constexpr int KS = HD / 16;         // k-steps of q k^T
  constexpr int NO = HD / 8;          // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x P
  __nv_bfloat16* ks = qs + BQ * P;    // 2 stages x kTK x P
  __nv_bfloat16* vs = ks + 2 * kTK * P;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  // the last query tiles (the longest causal reach) first, so the
  // card's tail runs the short ones
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;            // fragment row (and row + 8)
  const int c2 = 2 * (lane & 3);      // fragment column pair
  const __nv_bfloat16* qb = q + b * qst.b + h * qst.h;
  const __nv_bfloat16* kb = k + b * kst.b + kvh * kst.h;
  const __nv_bfloat16* vb = v + b * vst.b + kvh * vst.h;
  __nv_bfloat16* ob = o + b * ost.b + h * ost.h;

  for (int i = tid; i < BQ * kChunks; i += kThreadsB) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool in = q0 + r < Sq;
    ptx::cp_async_16(qs + r * P + c * 8,
                     qb + (in ? (q0 + r) * qst.s : 0) + c * 8, in);
  }
  ptx::cp_async_commit();

  // the keys some row of this tile can reach
  const int q_last = min(Sq, q0 + BQ) - 1;
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (window > 0) {
    k_lo = max(0, q0 - window + 1);
    if (!causal) k_hi = min(k_hi, q_last + window);
  }
  k_lo = (k_lo / kTK) * kTK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kTK - 1) / kTK : 0;

  auto load_kv = [&](int t) {
    const int k0 = k_lo + t * kTK;
    __nv_bfloat16* kd = ks + (t & 1) * kTK * P;
    __nv_bfloat16* vd = vs + (t & 1) * kTK * P;
    for (int i = tid; i < kTK * kChunks; i += kThreadsB) {
      const int r = i / kChunks, c = i - r * kChunks;
      const bool in = k0 + r < Skv;
      const long long row = in ? k0 + r : 0;
      ptx::cp_async_16(kd + r * P + c * 8, kb + row * kst.s + c * 8, in);
      ptx::cp_async_16(vd + r * P + c * 8, vb + row * vst.s + c * 8, in);
    }
    ptx::cp_async_commit();
  };

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};              // this thread's share of the sums
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[KS][4];

  if (n_tiles > 0) load_kv(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1);
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();                  // tile t (and q) landed for all
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ptx::ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * P +
                                     kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = ks + (t & 1) * kTK * P;
    const __nv_bfloat16* vt = vs + (t & 1) * kTK * P;

    // S = q k^T: 16 x 64 per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ptx::ldmatrix_x4(bf, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                      P + kk * 16 + ((lane >> 3) & 1) * 8);
        ptx::mma_bf16_16816(s[2 * np], qf[kk], bf[0], bf[1]);
        ptx::mma_bf16_16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // masks (on tiles where some pair of the block is out of reach),
    // then the online softmax on the fragments (base 2)
    const int k0 = k_lo + t * kTK;
    const int k1 = k0 + kTK - 1;
    const bool edge = k1 >= Skv || (causal && k1 > q0) ||
                      (window > 0 && (q_last - k0 >= window ||
                                      (!causal && k1 - q0 >= window)));
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int row = row0 + (e >> 1) * 8;
          const int col = k0 + n * 8 + c2 + (e & 1);
          bool ok = col < Skv;
          if (causal) ok = ok && col <= row;
          if (window > 0) {
            ok = ok && row - col < window;
            if (!causal) ok = ok && col - row < window;
          }
          x = ok ? x : kNeg;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
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

    // O += P V: P's accumulator fragments are the A fragments, in bf16
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      const uint32_t a[4] = {
          ptx::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          ptx::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          ptx::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          ptx::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bf[4];
        ptx::ldmatrix_x4_trans(
            bf, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                    np * 16 + (lane >> 4) * 8);
        ptx::mma_bf16_16816(acc[2 * np], a, bf[0], bf[1]);
        ptx::mma_bf16_16816(acc[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();                  // stage t & 1 is free for tile t + 2
  }
  ptx::cp_async_wait<0>();            // (q's copy, when no tile was in reach)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row < Sq) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(ob + row * ost.s + n * 8 + c2) =
            __floats2bfloat162_rn(acc[n][2 * r] / den,
                                  acc[n][2 * r + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16-accumulate mode (the config's attn_f32=False)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// The key chunks a block walks: chunk c holds keys [c C, min(c C + C, Skv))
// (dense: one chunk, C = Skv).  A block walks the chunks from the one
// holding k_lo to the one holding k_hi - 1, each in tiles of `tile` keys
// from the tile (counted from the chunk's start) that holds its first key
// in reach; keys past the chunk's end are masked.
struct Chunks {
  int C, k_lo, k_hi, Skv, tile;
  __device__ int first(int c) const {
    const int cs = c * C;
    return cs + (max(cs, k_lo) - cs) / tile * tile;
  }
  __device__ int lim(int c) const { return min(c * C + C, Skv); }
  __device__ int tiles(int c) const {
    return (min(lim(c), k_hi) - first(c) + tile - 1) / tile;
  }
  __device__ int count() const { return (k_hi + C - 1) / C; }  // c < count
};

// float32 q, k, v (the FMA kernel's layout and thread map).  Each chunk is
// walked twice: first for the row max (chunked) or the running max and
// sum (dense, the one chunk), then for the weights, rounded to bf16, times
// V rounded to bf16, summed in float32 into `cacc`.  Dense: the weights
// are exp(s - m) / l and the output is cacc rounded once to bf16.
// Chunked: the weights are exp(s - m_new), l sums them as rounded, and
// acc = bf16(bf16(acc * bf16(alpha)) + bf16(cacc)); the output is acc / l.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_acc_bf16_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ o, int H, int KV, int Sq,
                                int Skv, Strides qst, Strides kst,
                                Strides vst, Strides ost, int causal,
                                int window, float scale, int kv_chunk) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kCols = HD / 16;
  float* qs = smem;
  float* ks = qs + HD * kLd;
  float* vs = ks + HD * kLd;
  float* ps = vs + kBK * HD;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* qb = q + b * qst.b + h * qst.h;
  const float* kb = k + b * kst.b + kvh * kst.h;
  const float* vb = v + b * vst.b + kvh * vst.h;
  float* ob = o + b * ost.b + h * ost.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    qs[d * kLd + r] = q0 + r < Sq ? qb[(q0 + r) * qst.s + d] * scale : 0.f;
  }

  const int q_last = min(Sq, q0 + kBQ) - 1;
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (window > 0) {
    k_lo = max(0, q0 - window + 1);
    if (!causal) k_hi = min(k_hi, q_last + window);
  }
  const bool chunked = kv_chunk > 0;
  const Chunks ch{chunked ? kv_chunk : Skv, k_lo, k_hi, Skv, kBK};

  float m[4], l[4], acc[4][kCols], cacc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = cacc[i][c] = 0.f;
  }

  for (int c = k_lo / ch.C; c < ch.count(); ++c) {
    const int a0 = ch.first(c), a1 = a0 + ch.tiles(c) * kBK, ce = ch.lim(c);
    float cm[4] = {kNeg, kNeg, kNeg, kNeg};
    for (int k0 = a0; k0 < a1; k0 += kBK) {         // walk 1: statistics
      __syncthreads();
      for (int i = tid; i < kBK * HD; i += kThreads) {
        const int r = i / HD, d = i - r * HD;
        ks[d * kLd + r] = k0 + r < Skv ? kb[(k0 + r) * kst.s + d] : 0.f;
      }
      __syncthreads();
      float s[4][4];
      fma_scores<HD>(qs, ks, q0, k0, ce, ty, tx, causal, window, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = kNeg;
#pragma unroll
        for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
        mx = group_max(mx);
        if (chunked) {
          cm[i] = fmaxf(cm[i], mx);
        } else {
          const float m_new = fmaxf(m[i], mx);
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
          l[i] = l[i] * expf(m[i] - m_new) + group_sum(rs);
          m[i] = m_new;
        }
      }
    }
    float alpha[4], lc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lc[i] = 0.f;
      const float m_new = fmaxf(m[i], cm[i]);      // dense: m[i]
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    for (int k0 = a0; k0 < a1; k0 += kBK) {         // walk 2: weights . V
      __syncthreads();
      for (int i = tid; i < kBK * HD; i += kThreads) {
        const int r = i / HD, d = i - r * HD;
        const bool in = k0 + r < Skv;
        ks[d * kLd + r] = in ? kb[(k0 + r) * kst.s + d] : 0.f;
        vs[r * HD + d] = in ? bf16r(vb[(k0 + r) * vst.s + d]) : 0.f;
      }
      __syncthreads();
      float s[4][4];
      fma_scores<HD>(qs, ks, q0, k0, ce, ty, tx, causal, window, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = expf(s[i][j] - m[i]);
          const float w = bf16r(chunked ? e : e / l[i]);
          rs += w;
          ps[(tx * 4 + j) * kLd + ty * 4 + i] = w;
        }
        if (chunked) lc[i] += group_sum(rs);
      }
      __syncthreads();
      fma_pv<HD>(ps, vs, ty, tx, cacc);
    }
    if (chunked) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        l[i] = l[i] * alpha[i] + lc[i];
        const float ab = bf16r(alpha[i]);
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          acc[i][cc] = bf16r(bf16r(acc[i][cc] * ab) + bf16r(cacc[i][cc]));
          cacc[i][cc] = 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < Sq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        ob[row * ost.s + tx + 16 * cc] =
            chunked ? acc[i][cc] / den : bf16r(cacc[i][cc]);
    }
  }
}

// bfloat16 q, k, v on the tensor cores (the bf16 kernel's layout, q
// fragments in registers, a double-buffered cp.async ring), one
// instantiation per branch (CHUNKED), each holding only its own
// accumulators.  Each chunk (dense: the block's whole reach) is taken in
// two phases over its tiles, flattened into one sequence of steps (chunk,
// phase, tile) so that the next step's tiles are in flight while this one
// is worked on:
//
//   phase 0 runs q k^T on tile t's K for the statistics: chunked, the
//   chunk's row max; dense, the online max m and denominator l, the
//   values becoming exp(s - m_t) under the running max m_t;
//   phase 1 forms tile t's weights, rounds them to bf16 -- chunked
//   exp(s - m_new), dense exp(s - m) / l -- and feeds them to the P V mma
//   as its A fragments (the accumulator layout of q k^T is the A layout
//   of P V), summing in float32 (`cacc`).
//
// One walk (dense, cap > 0, every tile of the reach kept): phase 0 keeps
// each tile's values in this thread's slice of shared memory (dense: beside
// m_t), and phase 1 copies V alone and reads them back -- no second q k^T
// and no second copy of K.  A thread reads back only what it wrote, so
// the buffer needs no barrier; each warp-wide float4 store or load covers
// 512 contiguous bytes, free of bank conflicts.  Two walks (cap == 0): a
// ring stage holds two tiles, phase 0 copies and reduces two K tiles a
// step, and phase 1 copies K beside V and runs q k^T again.  Chunked, the
// carried accumulator is bf16 pairs in this thread's slice of shared
// memory, updated once a chunk: acc = bf16(bf16(acc bf16(alpha)) +
// bf16(cacc)).  The q tile shares its shared memory with the kept values
// and the accumulator, written only after every warp has read its q
// fragments.
template <int HD, int W, bool CHUNKED>
__global__ void __launch_bounds__(W * 32)
flash_attention_bf16_acc_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                     const __nv_bfloat16* __restrict__ k,
                                     const __nv_bfloat16* __restrict__ v,
                                     __nv_bfloat16* __restrict__ o, int H,
                                     int KV, int Sq, int Skv, Strides qst,
                                     Strides kst, Strides vst, Strides ost,
                                     int causal, int window,
                                     float scale_log2, int kv_chunk,
                                     int cap) {
  constexpr int P = HD + 8;
  constexpr int BQ = 16 * W;
  constexpr int kChunks = HD / 8;
  constexpr int kThreadsB = W * 32;
  constexpr int KS = HD / 16;
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // two ring stages (one tile: K or V; two walks: two tiles, K and K or K
  // and V), then the kept values (W x cap x 32 lanes x 32 floats) and
  // dense: the running max of each kept tile (W x cap x 32 float2),
  // chunked: acc (W x NO x 2 x 32 bf16 pairs); the q tile (BQ x P) lies
  // over the kept values, read into registers before any is written; the
  // host's `acc_bf16_smem` counts the same bytes
  const bool two = CHUNKED || cap == 0;   // chunked: two walks only
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int stage = (two ? 2 : 1) * kTK * P;
  const int voff = two ? kTK * P : 0;
  __nv_bfloat16* qs = ring + 2 * stage;
  float* kept = reinterpret_cast<float*>(qs);
  float* tail = kept + (size_t)W * cap * 1024;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
  const __nv_bfloat16* qb = q + b * qst.b + h * qst.h;
  const __nv_bfloat16* kb = k + b * kst.b + kvh * kst.h;
  const __nv_bfloat16* vb = v + b * vst.b + kvh * vst.h;
  __nv_bfloat16* ob = o + b * ost.b + h * ost.h;
  // this thread's slices: tile t, n-tile n at mine[(t * 8 + n) * 128]
  float* mine = kept + (size_t)warp * cap * 1024 + lane * 4;
  float2* snap = reinterpret_cast<float2*>(tail) + warp * cap * 32 + lane;
  uint32_t* accb = reinterpret_cast<uint32_t*>(tail) + warp * NO * 64 + lane;

  for (int i = tid; i < BQ * kChunks; i += kThreadsB) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool in = q0 + r < Sq;
    ptx::cp_async_16(qs + r * P + c * 8,
                     qb + (in ? (q0 + r) * qst.s : 0) + c * 8, in);
  }
  ptx::cp_async_commit();

  const int q_last = min(Sq, q0 + BQ) - 1;
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (window > 0) {
    k_lo = max(0, q0 - window + 1);
    if (!causal) k_hi = min(k_hi, q_last + window);
  }
  const Chunks ch{CHUNKED ? kv_chunk : Skv, k_lo, k_hi, Skv, kTK};
  const int n_chunks = ch.count();

  // steps (chunk, phase, tile); two walks: phase 0 takes tiles t, t + 1
  struct Step {
    int c, phase, t;
  };
  auto advance = [&](Step x) {
    x.t += x.phase == 0 && two ? 2 : 1;
    if (x.t >= ch.tiles(x.c)) {
      x.t = 0;
      if (x.phase) ++x.c;
      x.phase ^= 1;
    }
    return x;
  };
  auto load = [&](Step x, int buf) {
    const int k0 = ch.first(x.c) + x.t * kTK;
    __nv_bfloat16* st = ring + buf * stage;
    const bool second = x.phase == 0 && two && x.t + 1 < ch.tiles(x.c);
    for (int i = tid; i < kTK * kChunks; i += kThreadsB) {
      const int r = i / kChunks, c = i - r * kChunks;
      const bool in = k0 + r < Skv;
      const long long row = in ? k0 + r : 0;
      if (x.phase == 0 || two)
        ptx::cp_async_16(st + r * P + c * 8, kb + row * kst.s + c * 8, in);
      if (x.phase)
        ptx::cp_async_16(st + voff + r * P + c * 8, vb + row * vst.s + c * 8,
                         in);
      if (second) {
        const bool in2 = k0 + kTK + r < Skv;
        ptx::cp_async_16(st + voff + r * P + c * 8,
                         kb + (in2 ? k0 + kTK + r : 0) * kst.s + c * 8, in2);
      }
    }
    ptx::cp_async_commit();
  };

  const int row0 = q0 + warp * 16 + g;
  // dense: m the running max, l this thread's share of the sum (the rows'
  // reciprocal once phase 0 ends); chunked: m, l the rows' carried ones,
  // cm the chunk's max (this thread's share), lc the chunk's rounded sum
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float cm[2] = {kNeg, kNeg}, lc[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
  float cacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) cacc[n][e] = 0.f;

  uint32_t qf[KS][4];

  // phase 0 on the tile at kt: q k^T and the statistics (dense: s becomes
  // exp(s - m) under the running max)
  auto stats = [&](const __nv_bfloat16* kt, int c, int t, float (&s)[8][4]) {
    const int k0 = ch.first(c) + t * kTK;
    const int ce = ch.lim(c);
    float mx[2] = {kNeg, kNeg};
    mma_scores<HD>(qf, kt, lane, scale_log2,
                   tile_edge(k0, ce, q0, q_last, causal, window), row0, k0,
                   ce, causal, window, s, mx);
    if (CHUNKED) {
      cm[0] = fmaxf(cm[0], mx[0]);
      cm[1] = fmaxf(cm[1], mx[1]);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        l[r] *= exp2f(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - m[e >> 1]);
          l[e >> 1] += s[n][e];
        }
    }
  };

  Step cur{k_lo / ch.C, 0, 0};
  if (cur.c < n_chunks) load(cur, 0);
  for (int j = 0; cur.c < n_chunks; ++j) {
    const Step nxt = advance(cur);
    if (nxt.c < n_chunks) {
      load(nxt, (j + 1) & 1);
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ptx::ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * P +
                                     kk * 16 + (lane >> 4) * 8);
      __syncthreads();                // the q tile is free for kept values
      if (CHUNKED) {
#pragma unroll
        for (int i = 0; i < 2 * NO; ++i) accb[i * 32] = 0u;  // bf16 zeros
      }
    }
    const __nv_bfloat16* kt = ring + (j & 1) * stage;
    const __nv_bfloat16* vt = kt + voff;
    float* mt = mine + cur.t * 1024;

    float s[8][4];
    if (cur.phase == 0) {
      stats(kt, cur.c, cur.t, s);
      if (two) {
        if (cur.t + 1 < ch.tiles(cur.c)) stats(vt, cur.c, cur.t + 1, s);
      } else {
        if (!CHUNKED) snap[cur.t * 32] = make_float2(m[0], m[1]);
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float4*>(mt + n * 128) =
              make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      }
    } else if (two) {
      const int k0 = ch.first(cur.c) + cur.t * kTK;
      const int ce = ch.lim(cur.c);
      float mx[2] = {kNeg, kNeg};
      mma_scores<HD>(qf, kt, lane, scale_log2,
                     tile_edge(k0, ce, q0, q_last, causal, window), row0, k0,
                     ce, causal, window, s, mx);
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float4 x = *reinterpret_cast<const float4*>(mt + n * 128);
        s[n][0] = x.x;
        s[n][1] = x.y;
        s[n][2] = x.z;
        s[n][3] = x.w;
      }
    }

    if (cur.phase == 1) {
      if (CHUNKED) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float w = bf16r(exp2f(s[n][e] - m[e >> 1]));
            lc[e >> 1] += w;
            s[n][e] = w;
          }
      } else {
        // kept: exp(s - m_t) exp(m_t - m) / l; recomputed: exp(s - m) / l
        // (l holds the rows' reciprocals here)
        float gr[2] = {l[0], l[1]};
        if (!two) {
          const float2 mk = snap[cur.t * 32];
          gr[0] *= exp2f(mk.x - m[0]);
          gr[1] *= exp2f(mk.y - m[1]);
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = two ? exp2f(s[n][e] - m[e >> 1]) : s[n][e];
            s[n][e] = x * gr[e >> 1];
          }
      }
      mma_pv<HD>(s, vt, lane, cacc);  // rounds the weights to bf16
    }

    if (nxt.c != cur.c || nxt.phase != cur.phase) {  // a phase ends here
      if (cur.phase == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (CHUNKED) {
            const float m_new = fmaxf(m[r], quad_max(cm[r]));
            alpha[r] = exp2f(m[r] - m_new);
            m[r] = m_new;
            cm[r] = kNeg;
          } else {
            l[r] = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
          }
        }
      } else if (CHUNKED) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * alpha[r] + quad_sum(lc[r]);
          lc[r] = 0.f;
          const float ab = bf16r(alpha[r]);
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            const float2 a = unpack_bf16x2(accb[(2 * n + r) * 32]);
            accb[(2 * n + r) * 32] = ptx::pack_bf16x2(
                bf16r(a.x * ab) + bf16r(cacc[n][2 * r]),
                bf16r(a.y * ab) + bf16r(cacc[n][2 * r + 1]));
            cacc[n][2 * r] = cacc[n][2 * r + 1] = 0.f;
          }
        }
      }
    }
    __syncthreads();                  // buffer j & 1 is free for step j + 2
    cur = nxt;
  }
  ptx::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    // chunked: acc / l as one reciprocal a row (a division an element
    // left ptxas a stack frame at hd 96)
    const float inv = CHUNKED ? 1.f / fmaxf(l[r], 1e-30f) : 1.f;
    if (row < Sq) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        float2 x = make_float2(cacc[n][2 * r], cacc[n][2 * r + 1]);
        if (CHUNKED) {
          x = unpack_bf16x2(accb[(2 * n + r) * 32]);
          x.x *= inv;
          x.y *= inv;
        }
        *reinterpret_cast<__nv_bfloat162*>(ob + row * ost.s + n * 8 + c2) =
            __floats2bfloat162_rn(x.x, x.y);
      }
    }
  }
}

// shared memory of the kernel above (its layout, in bytes)
template <int HD, int W, bool CHUNKED>
size_t acc_bf16_smem(int cap) {
  const size_t P = HD + 8;
  const size_t kept =
      CHUNKED ? sizeof(uint32_t) * (size_t)W * (HD / 8) * 64
              : (sizeof(float) * 1024 + sizeof(float2) * 32) * (size_t)W * cap;
  const size_t q = 2 * P * 16 * W;
  return 2 * P * 2 * (cap ? 1 : 2) * kTK + (kept > q ? kept : q);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Call {
  const void *q, *k, *v;
  void* o;
  int B, H, KV, Sq, Skv;
  Strides qs, ks, vs, os;
  int causal, window;
  float scale;
  int kv_chunk, cap;
  cudaStream_t stream;
};

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int HD>
int launch_f32(const Call& c, bool acc_bf16) {
  const size_t smem = smem_bytes(HD);
  const dim3 grid(c.B * c.H, (c.Sq + kBQ - 1) / kBQ);
  const float *q = static_cast<const float*>(c.q),
              *k = static_cast<const float*>(c.k),
              *v = static_cast<const float*>(c.v);
  float* o = static_cast<float*>(c.o);
  if (acc_bf16) {
    auto kern = flash_attention_acc_bf16_kernel<HD>;
    if (const int e = prepare(kern, smem)) return e;
    kern<<<grid, kThreads, smem, c.stream>>>(
        q, k, v, o, c.H, c.KV, c.Sq, c.Skv, c.qs, c.ks, c.vs, c.os, c.causal,
        c.window, c.scale, c.kv_chunk);
  } else {
    auto kern = flash_attention_kernel<float, HD>;
    if (const int e = prepare(kern, smem)) return e;
    kern<<<grid, kThreads, smem, c.stream>>>(
        q, k, v, o, c.H, c.KV, c.Sq, c.Skv, c.qs, c.ks, c.vs, c.os, c.causal,
        c.window, c.scale);
  }
  return (int)cudaGetLastError();
}

// the largest shared-memory carveout, so that as many blocks of the
// bf16-accumulate kernel fit on an SM as its shared memory allows
template <int HD, int W, bool CHUNKED>
int prepare_acc_bf16(size_t smem) {
  auto kern = flash_attention_bf16_acc_bf16_kernel<HD, W, CHUNKED>;
  if (const int e = prepare(kern, smem)) return e;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

template <int HD, int W, bool CHUNKED>
int launch_acc_bf16(const Call& c) {
  const size_t smem = acc_bf16_smem<HD, W, CHUNKED>(c.cap);
  const dim3 grid(c.B * c.H, (c.Sq + 16 * W - 1) / (16 * W));
  auto kern = flash_attention_bf16_acc_bf16_kernel<HD, W, CHUNKED>;
  if (const int e = prepare_acc_bf16<HD, W, CHUNKED>(smem)) return e;
  kern<<<grid, W * 32, smem, c.stream>>>(
      static_cast<const __nv_bfloat16*>(c.q),
      static_cast<const __nv_bfloat16*>(c.k),
      static_cast<const __nv_bfloat16*>(c.v),
      static_cast<__nv_bfloat16*>(c.o), c.H, c.KV, c.Sq, c.Skv, c.qs, c.ks,
      c.vs, c.os, c.causal, c.window, c.scale * kLog2e, c.kv_chunk, c.cap);
  return (int)cudaGetLastError();
}

template <int HD, int W>
int launch_bf16(const Call& c, bool acc_bf16) {
  if (acc_bf16)
    return c.kv_chunk > 0 ? launch_acc_bf16<HD, W, true>(c)
                          : launch_acc_bf16<HD, W, false>(c);
  const size_t smem = bf16_smem_bytes<HD, W>();
  const dim3 grid(c.B * c.H, (c.Sq + 16 * W - 1) / (16 * W));
  auto kern = flash_attention_bf16_kernel<HD, W>;
  if (const int e = prepare(kern, smem)) return e;
  kern<<<grid, W * 32, smem, c.stream>>>(
      static_cast<const __nv_bfloat16*>(c.q),
      static_cast<const __nv_bfloat16*>(c.k),
      static_cast<const __nv_bfloat16*>(c.v),
      static_cast<__nv_bfloat16*>(c.o), c.H, c.KV, c.Sq, c.Skv, c.qs, c.ks,
      c.vs, c.os, c.causal, c.window, c.scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const Call& c, int dtype, int warps, bool acc_bf16) {
  if (dtype == 0) return launch_f32<HD>(c, acc_bf16);
  if (dtype == 1 && warps == 2) return launch_bf16<HD, 2>(c, acc_bf16);
  if (dtype == 1 && warps == 4) return launch_bf16<HD, 4>(c, acc_bf16);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One launch on `stream`.  q and o are (B, H, Sq, hd), k and v
// (B, KV, Skv, hd), each given by its base pointer and its (b, h, s)
// element strides (hd contiguous), all of one dtype: 0 = float32 (the FMA
// kernels), 1 = bfloat16 (the tensor-core kernels, `warps` of 16 query
// rows per block, 2 or 4; base pointers and strides 16-byte aligned).
// acc_bf16 = 0: the float32-accumulate kernels (kv_chunk is ignored: one
// online softmax computes the dense and the chunked function alike);
// 1: the bf16-accumulate kernels, dense when kv_chunk == 0, else over
// kv_chunk-key chunks; dense, the bf16 one keeps `cap` tiles' values in
// shared memory (one walk; cap = 0: two walks, as every chunked launch;
// see kernel.py `acc_bf16_route`).  Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for an hd,
// dtype, warp count, chunk width or cap it lacks (cap > 0 with chunks).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KV, int Sq, int Skv,
                           int hd, int dtype, long long qsb, long long qsh,
                           long long qss, long long ksb, long long ksh,
                           long long kss, long long vsb, long long vsh,
                           long long vss, long long osb, long long osh,
                           long long oss, int causal, int window, float scale,
                           int warps, int acc_bf16, int kv_chunk,
                           int cap, void* stream) {
  if (kv_chunk < 0 || cap < 0 || (kv_chunk > 0 && cap > 0))
    return (int)cudaErrorInvalidValue;
  const Call c{q, k, v, o, B, H, KV, Sq, Skv,
               Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss},
               Strides{vsb, vsh, vss}, Strides{osb, osh, oss},
               causal, window, scale, kv_chunk, cap,
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 32: return launch_hd<32>(c, dtype, warps, acc_bf16 != 0);
    case 64: return launch_hd<64>(c, dtype, warps, acc_bf16 != 0);
    case 96: return launch_hd<96>(c, dtype, warps, acc_bf16 != 0);
    case 128: return launch_hd<128>(c, dtype, warps, acc_bf16 != 0);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
