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
// a bf16-accumulate twin (below), all on the tensor cores:
//
// bfloat16: FlashAttention-2 on mma.sync.  A block of W warps (W = 2 when
// Sq <= 32, else 4: the launch picks it) holds 16 W query rows of one
// (b, h); each warp owns 16 rows.  q's tile comes into shared memory once
// and its A fragments (ldmatrix.x4) stay in registers across the KV loop.
// K and V tiles of 64 rows stream in with 16-byte cp.async copies,
// double-buffered (tile t+1 in flight while tile t is multiplied), rows
// past Skv zero-filled.  Rows are bf16 with a 16-byte pad (an odd count of
// 16-byte chunks per row at hd = 32..128), so every ldmatrix is free of
// bank conflicts.  S = q k^T is mma.sync m16n8k16 (bf16 in, float32
// accumulate) with K's row-major tile as the column-major B operand;
// `scale` multiplies the float32 scores (q cannot be scaled first: it is
// rounded to bf16 before the product).  The online softmax runs on the
// accumulator fragments (a thread holds two rows; row max and sum reduce
// over the 4-lane quad), in base 2 with log2(e) folded into the scale.  P
// is rounded to bf16 in registers: the m16n8 accumulator layout is the A
// layout of the next m16n8k16, so P never touches shared memory; P V runs
// on the same mma with V's fragments from ldmatrix.x4.trans.  Each weight
// is within 2^-9 relative of the float32 one, so an output moves by at
// most ~2^-9 max|v|; row sums and the output accumulate in float32.
// Masks are evaluated only on tiles where some (row, key) pair of the
// block is out of reach, and the query tiles with the longest causal
// reach are scheduled first, so the short ones fill the card's tail.
//
// float32: the same structure on mma.sync m16n8k8 in 3xTF32 (CUTLASS's
// "fast accurate" float32 product): each operand is split into two tf32
// values (big = cvt.rna of x; small = the exact x - big, whose leading 11
// bits the tensor cores read), and a b accumulates as a_small b_big +
// a_big b_small + a_big b_big in float32.  The left-out a_small b_small
// and the split's truncation are ~2^-21 relative a product, at the level
// of float32 summation order; one TF32 product (2^-11) would miss the
// decoder's float32 check against forward_lm (tests/test_torch_tf32x3.py
// holds both claims).  q's tile is scaled in
// float32 (as the plain version scales it) and kept in shared memory in
// fragment order (one 16-byte load a k-step, split at each use: its split
// fragments would take 128 registers at hd 128).  K and V tiles of 16 W
// float32 rows, at a pitch of hd + 4 floats, come in with 16-byte cp.async
// (4-byte where a view is not 16-byte aligned: the host decides from the
// tensors), one K and one V buffer staggered (K(t+1) lands under tile t's
// softmax and P V, V(t+1) under tile t+1's q k^T), so a block takes
// 100,352 bytes at hd 128 and two fit on an SM.  The scalar fragment loads
// are free of bank conflicts: K's (row 8n + g, column t) at bank 4g + t,
// V's (rows 2t, 2t + 1, column g) at 8t + g and 8t + 4 + g.  P V takes each
// 8-key k-step's keys in the order 0 2 4 6 1 3 5 7, so the score fragment
// is the A fragment as it stands (see `tf32_pv`).  The weights are
// exp2(s log2(e) - m log2(e)) with s log2(e) exact inside one fma.  The
// split's ALU work, issued by every warp for every K and V element it
// reads, costs these kernels about as much as the two extra products do
// (tests/torch_flash_variants.py on the H100: the three products on the
// raw float32 bits run in 0.70-0.94 of the time, big times big alone in
// 0.53-0.97).  A tile whose second half lies past the block's reach
// takes its products over the first half alone.
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
// then weights and P V.  Both kernels have two routes, chosen on the host
// from the shape (kernel.py `acc_bf16_route`): one walk (dense only) keeps
// every tile's float32 values in shared memory from the first phase to
// the second, so K and V are each copied once and q k^T runs once; two
// walks copy K again beside V and run q k^T again.  A kept tile costs 4 KB
// a warp (16 rows x 64 keys x 4 bytes), so one walk over a reference chunk
// (1024 keys, 64 KB a warp) leaves room for 2 warps on an SM; on an H100
// the bf16 kernel's one walk ran several times slower than two walks at
// 8-12 warps, and over 5 tiles (288 keys) mostly slower too, while over
// 1-3 tiles it was faster (PERF.md).  The host takes one walk for a dense
// reach of up to 3 tiles (the decoders' 32-token prefills) and two walks
// past that and for every chunked launch.  Dense and chunked are separate
// instantiations, each holding only its own accumulators.  Chunks (and
// tiles) outside a block's causal or window reach are skipped: the
// reference's fully masked leading chunks are wiped by alpha = 0 and its
// trailing ones leave (m, l, acc) as they are.  The float32 twin takes q
// k^T in 3xTF32 as above; its weights and V are bf16 by the function's
// own definition, so its P V is one bf16 m16n8k16 product (exact products,
// float32 sums) with V rounded as its fragments are read.  Over at most
// 32 keys (the 32-token prefills) its tiles are half tiles, in ring slots
// of 32 rows: the smaller block fits more blocks on an SM.
//
// All: on the TPU the KV blocks are a sequential grid axis with (m, l,
// acc) carried in VMEM scratch and fully masked blocks skipped with
// @pl.when; here a loop inside the block walks the KV tiles inside the
// causal and window reach only (the skip becomes the loop's bounds).  Any
// (b, h, s) strides: the wrapper hands the model's (B, S, H, hd) tensors
// over as (B, H, S, hd) views, so no transpose is copied (bf16 needs them
// 16-byte aligned, which the wrapper checks).
//
// Bound.  4 hd flops per live (query, key) pair against each of q, k, v, o
// read or written once: at hd = 96 and a few hundred positions that is
// above the card's bytes-to-flops balance, so the tensor-core rate (bf16
// 989 TFLOP/s dense; float32 in 3xTF32 a third of the 494.7 TF32 rate,
// the cheapest float32-accurate use of the card; the float32 twin's P V,
// bf16 by its function, at the bf16 rate) bounds long sequences;
// at the decoder's prefill (S = 32) bytes and launch latency do.  The bf16
// kernel reaches about a fifth of its rate at S = 2048: mma.sync is issued
// a warp at a time from registers, and every query tile re-reads its
// head's K and V from L2 (wgmma with TMA-fed tiles and a producer warp is
// the step beyond).  The bf16-accumulate mode's two walks run q k^T twice
// (6 hd flops a pair where the bound counts 4) and read K twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr float kNeg = -1e30f;

struct Strides {
  long long b, h, s;                  // elements; the hd axis has stride 1
};

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

// whether some (row, key) pair of the block on the `kt`-key tile at k0 is
// out of reach (rows q0..q_last; keys at or past `lim` are)
__device__ __forceinline__ bool tile_edge(int k0, int lim, int q0,
                                          int q_last, int causal, int window,
                                          int kt = kTK) {
  const int k1 = k0 + kt - 1;
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
    // chunked: acc / l as one approximate reciprocal a row (a division an
    // element, and later one a row, left ptxas a stack frame at hd 96)
    const float inv = CHUNKED ? ptx::rcp_approx(fmaxf(l[r], 1e-30f)) : 1.f;
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
// float32: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

// x = big + small for 3xTF32: big = cvt.rna(x), so x - big is exact and
// within 2^-11 |x|; small is x - big as it stands, of which the tensor
// cores read the leading 11 bits (truncation, as CUTLASS's fast float32
// product leaves it), so x - big - small' is within 2^-21 |x|.  A cvt.rna
// of small would halve that at one more instruction an operand, which
// made the float32 kernels 1.02-1.28x slower on the H100
// (tests/torch_flash_variants.py, `rna_small`)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = ptx::cvt_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b in 3xTF32: a = ab + as, b = (bb + bs) from the floats b0, b1;
// as bb + ab bs + ab bb, small terms first (as bs, ~2^-22 relative, is
// left out)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0,
                                           float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  ptx::mma_tf32_1688(d, as, bb0, bb1);
  ptx::mma_tf32_1688(d, ab, bs0, bs1);
  ptx::mma_tf32_1688(d, ab, bb0, bb1);
}

// The block's 16 W query rows (zero past Sq), times `scale` in float32 as
// the plain version scales them, into shared memory in fragment order:
// warp w's k-step kk is 32 lanes x 4 floats at qs + ((w HD / 8 + kk) 32 +
// lane) 4, the lane's m16n8k8 A fragment (rows g, g + 8 of the warp's 16,
// columns 8 kk + t, + 4), so a k-step is one 16-byte load.  Every load
// of a thread is issued before its first store (16-byte loads where the
// host found q's view aligned), so their latencies overlap.
__device__ __forceinline__ int q_slot(int r, int d, int HD) {
  const int rr = r & 15, dd = d & 7;
  return (((r >> 4) * (HD / 8) + (d >> 3)) * 32 + (rr & 7) * 4 + (dd & 3)) *
             4 +
         (rr >> 3) + 2 * (dd >> 2);
}

template <int HD, int W>
__device__ __forceinline__ void stage_q_f32(float* qs, const float* qb,
                                            long long qss, int q0, int Sq,
                                            float scale, int vec, int tid) {
  if (vec) {
    constexpr int C = HD / 4;         // 16-byte chunks a row
    constexpr int N = HD / 8;         // chunks a thread: 16 W C / 32 W
    float4 x[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = tid + j * 32 * W, r = i / C, c = i - r * C;
      x[j] = q0 + r < Sq ? *reinterpret_cast<const float4*>(
                               qb + (q0 + r) * qss + c * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = tid + j * 32 * W, r = i / C, d = (i - r * C) * 4;
      qs[q_slot(r, d, HD)] = x[j].x * scale;
      qs[q_slot(r, d + 1, HD)] = x[j].y * scale;
      qs[q_slot(r, d + 2, HD)] = x[j].z * scale;
      qs[q_slot(r, d + 3, HD)] = x[j].w * scale;
    }
  } else {
    constexpr int N = HD / 2;         // elements a thread
#pragma unroll 16
    for (int j = 0; j < N; ++j) {
      const int i = tid + j * 32 * W, r = i / HD, d = i - r * HD;
      qs[q_slot(r, d, HD)] =
          q0 + r < Sq ? qb[(q0 + r) * qss + d] * scale : 0.f;
    }
  }
}

// One float32 tile of `rows` rows (k0.., zero past Skv) into shared
// memory at a pitch of HD + 4 floats: 16-byte cp.async where the host
// found the views 16-byte aligned (`vec`), else 4-byte.  One commit group.
template <int HD, int NTHR>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long ss, int k0, int Skv,
                                              int rows, int vec, int tid) {
  constexpr int PK = HD + 4;
  if (vec) {
    constexpr int C = HD / 4;
    for (int i = tid; i < rows * C; i += NTHR) {
      const int r = i / C, c = i - r * C;
      const bool in = k0 + r < Skv;
      ptx::cp_async_16(dst + r * PK + c * 4,
                       src + (in ? (k0 + r) * ss : 0) + c * 4, in);
    }
  } else {
    for (int i = tid; i < rows * HD; i += NTHR) {
      const int r = i / HD, c = i - r * HD;
      const bool in = k0 + r < Skv;
      ptx::cp_async_4(dst + r * PK + c, src + (in ? (k0 + r) * ss : 0) + c,
                      in);
    }
  }
  ptx::cp_async_commit();
}

// S = q k^T in 3xTF32 for a warp's 16 rows (qw: its q fragments, as
// staged) against the NT x 8 keys of the float32 tile kt: K's row-major
// rows are B's columns (b0 = K[8 n + g][8 kk + t], b1 = column + 4; bank
// 4 g + t at the pitch HD + 4, free of conflicts)
template <int HD, int NT>
__device__ __forceinline__ void tf32_scores(const float* qw, const float* kt,
                                            int lane, float (&s)[NT][4]) {
  constexpr int PK = HD + 4;
  const float* kr = kt + (lane >> 2) * PK + (lane & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float4 a =
        *reinterpret_cast<const float4*>(qw + (kk * 32 + lane) * 4);
    uint32_t ab[4], as[4];
    split_tf32(a.x, ab[0], as[0]);
    split_tf32(a.y, ab[1], as[1]);
    split_tf32(a.z, ab[2], as[2]);
    split_tf32(a.w, ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_3xtf32(s[n], ab, as, kr[n * 8 * PK + kk * 8],
                 kr[n * 8 * PK + kk * 8 + 4]);
  }
}

// s times `mul`, the pairs out of reach set to kNeg on an edge tile (this
// thread's rows row0, row0 + 8; keys k0 + 8 n + c2, + 1), each row's max
// folded into mx
template <int NT>
__device__ __forceinline__ void mask_max(float (&s)[NT][4], float mul,
                                         bool edge, int row0, int k0, int c2,
                                         int lim, int causal, int window,
                                         float (&mx)[2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * mul;
      if (edge && !in_reach(row0 + (e >> 1) * 8, k0 + n * 8 + c2 + (e & 1),
                            lim, causal, window))
        x = kNeg;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
}

// acc += P V in 3xTF32 for a warp's 16 rows.  An m16n8k8 A fragment holds
// columns t and t + 4 of its 8 keys, where the score fragment holds 2 t
// and 2 t + 1; so each k-step takes its 8 keys in the order 0 2 4 6 1 3 5
// 7 (slot t = key 2 t, slot t + 4 = key 2 t + 1) in both operands -- a
// sum over keys in another order.  The score fragment is then the A
// fragment as it stands (no shuffle, nothing through shared memory), and
// V's B fragment reads rows 2 t and 2 t + 1 (b0 = V[2 t][8 n + g], b1 =
// V[2 t + 1][8 n + g]; banks 8 t + g and 8 t + 4 + g, free of conflicts)
template <int HD, int NT>
__device__ __forceinline__ void tf32_pv(const float (&p)[NT][4],
                                        const float* vt, int lane,
                                        float (&acc)[HD / 8][4]) {
  constexpr int PK = HD + 4;
  const float* vr = vt + 2 * (lane & 3) * PK + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(p[kk][0], ab[0], as[0]);
    split_tf32(p[kk][2], ab[1], as[1]);
    split_tf32(p[kk][1], ab[2], as[2]);
    split_tf32(p[kk][3], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      mma_3xtf32(acc[n], ab, as, vr[kk * 8 * PK + n * 8],
                 vr[(kk * 8 + 1) * PK + n * 8]);
  }
}

// float32 q, k, v, float32 accumulate: FlashAttention-2 on 3xTF32
// mma.sync.  Blocks of W warps (16 query rows each) walk KT = 16 W key
// tiles.  One K and one V buffer, staggered: K(t + 1) is copied while the
// softmax and P V of tile t run, V(t + 1) while q k^T of tile t + 1 runs.
// The online softmax is in base 2: a row's weights are exp2(s log2(e) -
// m log2(e)) with s log2(e) exact inside one fma, and m log2(e) one
// rounding shared by the row (it cancels in the normalisation); a row
// with no key in reach yet has weights 0 (offset 0, alpha 0).
template <int HD, int W>
__global__ void __launch_bounds__(W * 32)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int H, int KV, int Sq, int Skv, Strides qst,
                           Strides kst, Strides vst, Strides ost, int causal,
                           int window, float scale, int vec) {
  constexpr int PK = HD + 4;
  constexpr int BQ = 16 * W;          // query rows per block
  constexpr int KT = 16 * W;          // key rows per tile
  constexpr int NT = KT / 8;          // n-tiles of q k^T
  constexpr int NO = HD / 8;          // n-tiles of the output
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // BQ x HD, fragment order
  float* ks = qs + BQ * HD;           // KT x PK
  float* vs = ks + KT * PK;           // KT x PK

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  // the last query tiles (the longest causal reach) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c2 = 2 * (lane & 3);
  const float* kb = k + b * kst.b + kvh * kst.h;
  const float* vb = v + b * vst.b + kvh * vst.h;
  float* ob = o + b * ost.b + h * ost.h;

  const int q_last = min(Sq, q0 + BQ) - 1;
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (window > 0) {
    k_lo = max(0, q0 - window + 1);
    if (!causal) k_hi = min(k_hi, q_last + window);
  }
  k_lo = (k_lo / KT) * KT;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + KT - 1) / KT : 0;
  if (n_tiles > 0) {
    load_tile_f32<HD, W * 32>(ks, kb, kst.s, k_lo, Skv, KT, vec, tid);
    load_tile_f32<HD, W * 32>(vs, vb, vst.s, k_lo, Skv, KT, vec, tid);
  }
  stage_q_f32<HD, W>(qs, q + b * qst.b + h * qst.h, qst.s, q0, Sq, scale,
                     vec, tid);
  const float* qw = qs + warp * 16 * HD;

  const int row0 = q0 + warp * 16 + (lane >> 2);  // and row0 + 8
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};            // this thread's share of the sums
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * KT;
    const bool more = t + 1 < n_tiles;
    ptx::cp_async_wait<1>();          // K(t) landed (V(t) may be in flight)
    __syncthreads();
    // a tile whose second half lies past the block's reach (Skv, or the
    // causal or window end) takes products over its first half alone
    // (the rest are masked: weights 0); not at hd 128, where it made
    // Pixtral's prefill 1.09x slower on the H100
    // (tests/torch_flash_variants.py, `f32_half_hd128`)
    constexpr int NH = NT / 2;
    const bool half = HD <= 96 && k0 + KT / 2 >= k_hi;
    float s[NT][4];
    if (half) {
      tf32_scores<HD, NH>(qw, ks, lane, reinterpret_cast<float(&)[NH][4]>(s));
#pragma unroll
      for (int n = NH; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    } else {
      tf32_scores<HD, NT>(qw, ks, lane, s);
    }
    __syncthreads();                  // every warp is done with K(t)
    if (more)
      load_tile_f32<HD, W * 32>(ks, kb, kst.s, k0 + KT, Skv, KT, vec, tid);

    float mx[2] = {m[0], m[1]};
    mask_max<NT>(s, 1.f, tile_edge(k0, Skv, q0, q_last, causal, window, KT),
                 row0, k0, c2, Skv, causal, window, mx);
    float off[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = quad_max(mx[r]);
      off[r] = mn == kNeg ? 0.f : mn * kLog2e;
      alpha[r] = m[r] == kNeg ? 0.f : exp2f(m[r] * kLog2e - off[r]);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(fmaf(s[n][e], kLog2e, -off[e >> 1]));
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    if (more) {
      ptx::cp_async_wait<1>();        // V(t) landed (K(t + 1) in flight)
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();
    if (half) {
      tf32_pv<HD, NH>(reinterpret_cast<const float(&)[NH][4]>(s), vs, lane,
                      acc);
    } else {
      tf32_pv<HD, NT>(s, vs, lane, acc);
    }
    __syncthreads();                  // every warp is done with V(t)
    if (more)
      load_tile_f32<HD, W * 32>(vs, vb, vst.s, k0 + KT, Skv, KT, vec, tid);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    // one approximate reciprocal a row (within 1 ulp: IEEE division's
    // slow path left ptxas a stack frame here)
    const float inv = ptx::rcp_approx(fmaxf(quad_sum(l[r]), 1e-30f));
    if (row < Sq) {
      float* orow = ob + row * ost.s + c2;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        orow[n * 8] = acc[n][2 * r] * inv;
        orow[n * 8 + 1] = acc[n][2 * r + 1] * inv;
      }
    }
  }
}

template <int HD, int W>
size_t f32_smem_bytes() {
  return sizeof(float) * (size_t)16 * W * (HD + 2 * (HD + 4));
}

// acc += P V on the bf16 tensor cores for a warp's 16 rows, from the
// float32 V tile vt (pitch HD + 4): P's accumulator fragments, rounded to
// bf16, are the A fragments of the next m16n8k16 (as `mma_pv`), and V's
// B fragments are its rows 2 t, 2 t + 1, 2 t + 8, 2 t + 9 of each 16 keys
// at column 8 n + g, rounded to bf16 as they are read (banks 8 t + g and
// 8 t + 4 + g, free of conflicts).  Every product of two bf16 values is
// exact in float32, so one product replaces 3xTF32's three.
// KK k-steps of 16 keys: 4 for the whole tile, 2 for its first half.
template <int HD, int KK>
__device__ __forceinline__ void bf16_pv_f32v(const float (&p)[8][4],
                                             const float* vt, int lane,
                                             float (&acc)[HD / 8][4]) {
  constexpr int PK = HD + 4;
  const float* vr = vt + 2 * (lane & 3) * PK + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint32_t a[4] = {
        ptx::pack_bf16x2(p[2 * kk][0], p[2 * kk][1]),
        ptx::pack_bf16x2(p[2 * kk][2], p[2 * kk][3]),
        ptx::pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        ptx::pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const float* x = vr + kk * 16 * PK;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      ptx::mma_bf16_16816(
          acc[n], a, ptx::pack_bf16x2(x[n * 8], x[PK + n * 8]),
          ptx::pack_bf16x2(x[8 * PK + n * 8], x[9 * PK + n * 8]));
  }
}

// Rows of the float32 twin's ring slots: 32 for a dense launch over at
// most 32 keys (the decoders' 32-token prefills: every tile is then a half
// tile, below, and the smaller block fits more of them on an SM), else a
// tile.
template <bool CHUNKED>
__host__ __device__ __forceinline__ int f32_slot_rows(int Skv) {
  return !CHUNKED && Skv <= kTK / 2 ? kTK / 2 : kTK;
}

// float32 q, k, v in the bf16-accumulate mode: the bf16 twin's phases
// and routes (below) on float32 tiles.  q k^T is the float32-accumulate
// kernel's 3xTF32 product (q staged in fragment order, scaled in
// float32), its scores taken to base 2 with one rounding; P V runs on the
// bf16 tensor cores with V rounded to bf16 as its fragments are read
// (`bf16_pv_f32v`).  Two ring slots of one 64-key tile each take the
// steps' tiles in turn: phase 0 a K tile a step; phase 1 of two walks K
// and then V, the scores kept in registers from one step to the next; of
// one walk V alone.  Chunked, the carried accumulator is bf16 pairs in
// registers.
// (No launch bound: tests/torch_flash_variants.py builds and times the
// two tried, `twin_thread_bound` and `twin_min_blocks`.)
template <int HD, int W, bool CHUNKED>
__global__ void
flash_attention_f32_acc_bf16_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    float* __restrict__ o, int H, int KV,
                                    int Sq, int Skv, Strides qst, Strides kst,
                                    Strides vst, Strides ost, int causal,
                                    int window, float scale, int kv_chunk,
                                    int cap, int vec) {
  constexpr int PK = HD + 4;
  constexpr int BQ = 16 * W;
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) float smem[];
  // q (BQ x HD, fragment order), two ring slots, then (one walk) the kept
  // values (W x cap x 32 lanes x 32 floats) and the running max of each
  // kept tile (W x cap x 32 float2), as `f32_acc_bf16_smem` counts them.
  const bool two = CHUNKED || cap == 0;
  const int rows = f32_slot_rows<CHUNKED>(Skv);
  const int TS = rows * PK;           // floats a ring slot
  float* qs = smem;
  float* ring = qs + BQ * HD;
  float* kept = ring + 2 * TS;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c2 = 2 * (lane & 3);
  const float* kb = k + b * kst.b + kvh * kst.h;
  const float* vb = v + b * vst.b + kvh * vst.h;
  float* ob = o + b * ost.b + h * ost.h;
  float* mine = kept + (size_t)warp * cap * 1024 + lane * 4;
  float2* snap =
      reinterpret_cast<float2*>(kept + (size_t)W * cap * 1024) +
      warp * cap * 32 + lane;

  const int q_last = min(Sq, q0 + BQ) - 1;
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (window > 0) {
    k_lo = max(0, q0 - window + 1);
    if (!causal) k_hi = min(k_hi, q_last + window);
  }
  const Chunks ch{CHUNKED ? kv_chunk : Skv, k_lo, k_hi, Skv, kTK};
  const int n_chunks = ch.count();

  // steps (chunk, phase, tile, V's tile or K's)
  struct Step {
    int c, phase, t, v;
  };
  auto advance = [&](Step x) {
    if (x.phase == 1 && two && !x.v) {
      x.v = 1;
      return x;
    }
    if (++x.t == ch.tiles(x.c)) {
      x.t = 0;
      if (x.phase) ++x.c;
      x.phase ^= 1;
    }
    x.v = x.phase == 1 && !two;
    return x;
  };
  auto load = [&](Step x, int slot) {
    load_tile_f32<HD, W * 32>(ring + slot * TS, x.v ? vb : kb,
                              x.v ? vst.s : kst.s, ch.first(x.c) + x.t * kTK,
                              Skv, rows, vec, tid);
  };

  Step cur{k_lo / ch.C, 0, 0, 0};
  if (cur.c < n_chunks) load(cur, 0);
  stage_q_f32<HD, W>(qs, q + b * qst.b + h * qst.h, qst.s, q0, Sq, scale,
                     vec, tid);
  const float* qw = qs + warp * 16 * HD;

  const int row0 = q0 + warp * 16 + (lane >> 2);
  // as the bf16 twin: dense, m the running max and l this thread's share
  // of the sum (the rows' reciprocal once phase 0 ends); chunked, m and l
  // the rows' carried ones, cm the chunk's max, lc its rounded sum
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float cm[2] = {kNeg, kNeg}, lc[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
  float cacc[NO][4];
  uint32_t accb[NO][2];               // chunked: bf16 pairs, rows g, g + 8
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) cacc[n][e] = 0.f;
    accb[n][0] = accb[n][1] = 0u;
  }
  float s[8][4];

  for (int j = 0; cur.c < n_chunks; ++j) {
    const Step nxt = advance(cur);
    if (nxt.c < n_chunks) {
      load(nxt, (j + 1) & 1);
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();
    const float* tile = ring + (j & 1) * TS;
    float* mt = mine + cur.t * 1024;

    const int k0 = ch.first(cur.c) + cur.t * kTK;
    const int ce = ch.lim(cur.c);
    // a tile whose second half lies past the chunk or the block's reach
    // -- the decoders' 32-key prefills -- takes products over its first
    // half alone: the rest are masked (weights 0)
    const bool half = k0 + kTK / 2 >= min(ce, k_hi);
    if (!cur.v) {                     // q k^T on K's tile, in base 2
      float mx[2] = {kNeg, kNeg};
      if (half) {
        tf32_scores<HD, 4>(qw, tile, lane,
                           reinterpret_cast<float(&)[4][4]>(s));
#pragma unroll
        for (int n = 4; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      } else {
        tf32_scores<HD, 8>(qw, tile, lane, s);
      }
      mask_max<8>(s, kLog2e, tile_edge(k0, ce, q0, q_last, causal, window),
                  row0, k0, c2, ce, causal, window, mx);
      if (cur.phase == 0) {
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
          if (!two) snap[cur.t * 32] = make_float2(m[0], m[1]);
        }
        if (!two) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *reinterpret_cast<float4*>(mt + n * 128) =
                make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        }
      }
    } else {                          // the weights, times V's tile
      if (!two) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float4 x = *reinterpret_cast<const float4*>(mt + n * 128);
          s[n][0] = x.x;
          s[n][1] = x.y;
          s[n][2] = x.z;
          s[n][3] = x.w;
        }
      }
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
      if (half) {                     // rounds the weights to bf16
        bf16_pv_f32v<HD, 2>(s, tile, lane, cacc);
      } else {
        bf16_pv_f32v<HD, 4>(s, tile, lane, cacc);
      }
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
            l[r] = ptx::rcp_approx(fmaxf(quad_sum(l[r]), 1e-30f));
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
            const float2 a = unpack_bf16x2(accb[n][r]);
            accb[n][r] = ptx::pack_bf16x2(
                bf16r(a.x * ab) + bf16r(cacc[n][2 * r]),
                bf16r(a.y * ab) + bf16r(cacc[n][2 * r + 1]));
            cacc[n][2 * r] = cacc[n][2 * r + 1] = 0.f;
          }
        }
      }
    }
    __syncthreads();                  // slot j & 1 is free for step j + 2
    cur = nxt;
  }
  ptx::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const float inv = CHUNKED ? ptx::rcp_approx(fmaxf(l[r], 1e-30f)) : 1.f;
    if (row < Sq) {
      float* orow = ob + row * ost.s + c2;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        float2 x;
        if (CHUNKED) {
          x = unpack_bf16x2(accb[n][r]);
          x.x *= inv;
          x.y *= inv;
        } else {
          x = make_float2(bf16r(cacc[n][2 * r]), bf16r(cacc[n][2 * r + 1]));
        }
        orow[n * 8] = x.x;
        orow[n * 8 + 1] = x.y;
      }
    }
  }
}

// shared memory of the kernel above (its layout, in bytes), with ring
// slots of `rows` rows (kernel.py's `f32_acc_bf16_smem` counts a tile)
template <int HD, int W>
size_t f32_acc_bf16_smem(int cap, int rows) {
  return sizeof(float) * ((size_t)16 * W * HD + 2 * (size_t)rows * (HD + 4)) +
         (sizeof(float) * 1024 + sizeof(float2) * 32) * (size_t)W * cap;
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
  int kv_chunk, cap, vec;
  cudaStream_t stream;
};

// the dynamic shared memory a kernel takes and, `carveout`, the largest
// shared-memory carveout, so that as many blocks fit on an SM as their
// shared memory allows
template <typename Kern>
int prepare(Kern kern, size_t smem, bool carveout = true) {
  if (smem > 48 * 1024) {
    if (const int e = (int)cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return e;
  }
  if (!carveout) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

template <int HD, int W, bool CHUNKED>
int launch_acc_bf16(const Call& c) {
  const size_t smem = acc_bf16_smem<HD, W, CHUNKED>(c.cap);
  const dim3 grid(c.B * c.H, (c.Sq + 16 * W - 1) / (16 * W));
  auto kern = flash_attention_bf16_acc_bf16_kernel<HD, W, CHUNKED>;
  if (const int e = prepare(kern, smem)) return e;
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
  if (const int e = prepare(kern, smem, false)) return e;
  kern<<<grid, W * 32, smem, c.stream>>>(
      static_cast<const __nv_bfloat16*>(c.q),
      static_cast<const __nv_bfloat16*>(c.k),
      static_cast<const __nv_bfloat16*>(c.v),
      static_cast<__nv_bfloat16*>(c.o), c.H, c.KV, c.Sq, c.Skv, c.qs, c.ks,
      c.vs, c.os, c.causal, c.window, c.scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int HD, int W, bool CHUNKED>
int launch_f32_acc_bf16(const Call& c) {
  const size_t smem =
      f32_acc_bf16_smem<HD, W>(c.cap, f32_slot_rows<CHUNKED>(c.Skv));
  const dim3 grid(c.B * c.H, (c.Sq + 16 * W - 1) / (16 * W));
  auto kern = flash_attention_f32_acc_bf16_kernel<HD, W, CHUNKED>;
  if (const int e = prepare(kern, smem)) return e;
  kern<<<grid, W * 32, smem, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<float*>(c.o), c.H, c.KV,
      c.Sq, c.Skv, c.qs, c.ks, c.vs, c.os, c.causal, c.window, c.scale,
      c.kv_chunk, c.cap, c.vec);
  return (int)cudaGetLastError();
}

template <int HD, int W>
int launch_f32(const Call& c, bool acc_bf16) {
  if (acc_bf16)
    return c.kv_chunk > 0 ? launch_f32_acc_bf16<HD, W, true>(c)
                          : launch_f32_acc_bf16<HD, W, false>(c);
  const size_t smem = f32_smem_bytes<HD, W>();
  const dim3 grid(c.B * c.H, (c.Sq + 16 * W - 1) / (16 * W));
  auto kern = flash_attention_f32_kernel<HD, W>;
  if (const int e = prepare(kern, smem)) return e;
  kern<<<grid, W * 32, smem, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<float*>(c.o), c.H, c.KV,
      c.Sq, c.Skv, c.qs, c.ks, c.vs, c.os, c.causal, c.window, c.scale,
      c.vec);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const Call& c, int dtype, int warps, bool acc_bf16) {
  if (dtype == 0 && warps == 2) return launch_f32<HD, 2>(c, acc_bf16);
  if (dtype == 0 && warps == 4) return launch_f32<HD, 4>(c, acc_bf16);
  if (dtype == 1 && warps == 2) return launch_bf16<HD, 2>(c, acc_bf16);
  if (dtype == 1 && warps == 4) return launch_bf16<HD, 4>(c, acc_bf16);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One launch on `stream`.  q and o are (B, H, Sq, hd), k and v
// (B, KV, Skv, hd), each given by its base pointer and its (b, h, s)
// element strides (hd contiguous), all of one dtype: 0 = float32 (3xTF32
// on the tensor cores), 1 = bfloat16 (base pointers and strides 16-byte
// aligned), in blocks of `warps` warps of 16 query rows, 2 or 4.  `vec`
// (float32): q's, k's and v's base pointers and strides are 16-byte
// aligned, so their rows are read 16 bytes at a time (0: 4 bytes).
// acc_bf16 = 0: the float32-accumulate kernels (kv_chunk is ignored:
// one online softmax computes the dense and the chunked function alike);
// 1: the bf16-accumulate kernels, dense when kv_chunk == 0, else over
// kv_chunk-key chunks; dense, they keep `cap` tiles' values in shared
// memory (one walk; cap = 0: two walks, as every chunked launch; see
// kernel.py `acc_bf16_route`).  Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for an hd, dtype, warp
// count, chunk width or cap it lacks (cap > 0 with chunks).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KV, int Sq, int Skv,
                           int hd, int dtype, long long qsb, long long qsh,
                           long long qss, long long ksb, long long ksh,
                           long long kss, long long vsb, long long vsh,
                           long long vss, long long osb, long long osh,
                           long long oss, int causal, int window, float scale,
                           int warps, int acc_bf16, int kv_chunk, int cap,
                           int vec, void* stream) {
  if (kv_chunk < 0 || cap < 0 || (kv_chunk > 0 && cap > 0))
    return (int)cudaErrorInvalidValue;
  const Call c{q, k, v, o, B, H, KV, Sq, Skv,
               Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss},
               Strides{vsb, vsh, vss}, Strides{osb, osh, oss},
               causal, window, scale, kv_chunk, cap, vec,
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
