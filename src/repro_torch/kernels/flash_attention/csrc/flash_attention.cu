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
// memory.  Two kernels, chosen by dtype (never after a failure):
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
// the float32 kernel is capped at the 67 TFLOP/s FMA rate.

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
// launches
// ---------------------------------------------------------------------------

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KV, int Sq, int Skv, Strides qs, Strides ks,
               Strides vs, Strides os, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(HD);
  auto kern = flash_attention_kernel<float, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, Sq, Skv,
      qs, ks, vs, os, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD, int W>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KV, int Sq, int Skv, Strides qs, Strides ks,
                Strides vs, Strides os, int causal, int window, float scale,
                cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<HD, W>();
  auto kern = flash_attention_bf16_kernel<HD, W>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (Sq + 16 * W - 1) / (16 * W));
  kern<<<grid, W * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, KV, Sq, Skv, qs, ks, vs, os, causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16_w(int warps, const void* q, const void* k, const void* v,
                  void* o, int B, int H, int KV, int Sq, int Skv, Strides qs,
                  Strides ks, Strides vs, Strides os, int causal, int window,
                  float scale, cudaStream_t st) {
  if (warps == 2)
    return launch_bf16<HD, 2>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os,
                              causal, window, scale, st);
  if (warps == 4)
    return launch_bf16<HD, 4>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os,
                              causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One launch on `stream`.  q and o are (B, H, Sq, hd), k and v
// (B, KV, Skv, hd), each given by its base pointer and its (b, h, s)
// element strides (hd contiguous), all of one dtype: 0 = float32 (the FMA
// kernel), 1 = bfloat16 (the tensor-core kernel, `warps` of 16 query rows
// per block, 2 or 4; base pointers and strides 16-byte aligned).  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an hd, dtype or warp count it lacks.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KV, int Sq, int Skv,
                           int hd, int dtype, long long qsb, long long qsh,
                           long long qss, long long ksb, long long ksh,
                           long long kss, long long vsb, long long vsh,
                           long long vss, long long osb, long long osh,
                           long long oss, int causal, int window, float scale,
                           int warps, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (hd) {
      case 32: return launch_f32<32>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks,
                                     vs, os, causal, window, scale, s);
      case 64: return launch_f32<64>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks,
                                     vs, os, causal, window, scale, s);
      case 96: return launch_f32<96>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks,
                                     vs, os, causal, window, scale, s);
      case 128: return launch_f32<128>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks,
                                       vs, os, causal, window, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (hd) {
      case 32: return launch_bf16_w<32>(warps, q, k, v, o, B, H, KV, Sq, Skv,
                                        qs, ks, vs, os, causal, window, scale,
                                        s);
      case 64: return launch_bf16_w<64>(warps, q, k, v, o, B, H, KV, Sq, Skv,
                                        qs, ks, vs, os, causal, window, scale,
                                        s);
      case 96: return launch_bf16_w<96>(warps, q, k, v, o, B, H, KV, Sq, Skv,
                                        qs, ks, vs, os, causal, window, scale,
                                        s);
      case 128: return launch_bf16_w<128>(warps, q, k, v, o, B, H, KV, Sq,
                                          Skv, qs, ks, vs, os, causal, window,
                                          scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
