// Blocked online-softmax attention (prefill / full sequence), for Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (body `_kernel`): softmax((q * scale) k^T) v per (batch
// row, query head), GQA by reading KV head h / (H / KV), with positional
// masks on implicit positions (query row i and key row j are positions i
// and j): causal (j <= i), a sliding window (i - j < W, and j - i < W when
// not causal) or none.  q is cast to float32 before the scale, as the
// plain version ../ref.py; scale defaults to hd^-0.5 in the wrapper (the
// decoder scales q in its compute dtype itself and passes 1).  Masked
// scores are -1e30.  The (Sq x Skv) score matrix never exists in device
// memory.
//
// Design.  On the TPU the KV blocks are a sequential grid axis with
// (m, l, acc) carried in VMEM scratch, and fully masked blocks are skipped
// with @pl.when.  Here one block per (b, h, tile of kBQ query rows) loops
// over the KV tiles inside the causal and window reach only (the skip
// becomes the loop's bounds).  The block stages its q tile once (float32,
// scaled, transposed) and each K tile (float32, transposed) and V tile in
// shared memory; 256 threads as 16 x 16 each own a 4 x 4 patch of the
// tile's scores (a register-tiled outer product over hd, two 16-byte
// shared loads per 16 FMAs), reduce row max and row sum over their 16-lane
// group by shuffles, write the weights back to shared memory, and fold
// them into a 4-row x hd/16-column slice of the float32 accumulator held in
// registers.  Any strides: the wrapper hands the model's (B, S, H, hd)
// tensors over as (B, H, S, hd) views, so no transpose is copied.  bf16
// and float32 inputs, float32 FMA arithmetic throughout (no tensor cores).
//
// Bound.  4 hd flops per live (query, key) pair against each of q, k, v, o
// read or written once: at hd = 96 and a few hundred positions that is
// well above the card's bytes-to-flops balance, so arithmetic bounds it —
// at the bf16 tensor-core rate, which this float32-FMA kernel cannot reach
// (67 TFLOP/s peak against 989).  mma.sync, then wgmma with TMA-fed K/V
// tiles and a producer warp, are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // key rows per tile
constexpr int kThreads = 256;         // 16 x 16, a 4 x 4 patch each
constexpr int kLd = kBQ + 4;          // row pitch of the transposed tiles
constexpr float kNeg = -1e30f;

static_assert(kBQ == kBK, "the transposed tiles share one pitch");

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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(HD);
  auto kern = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Skv, qs, ks,
      vs, os, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KV, int Sq, int Skv, int hd, Strides qs, Strides ks,
             Strides vs, Strides os, int causal, int window, float scale,
             cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os,
                           causal, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os,
                           causal, window, scale, st);
    case 96:
      return launch<T, 96>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os,
                           causal, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os,
                            causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One launch on `stream`.  q and o are (B, H, Sq, hd), k and v
// (B, KV, Skv, hd), each given by its base pointer and its (b, h, s)
// element strides (hd contiguous), all of one dtype (0 = float32,
// 1 = bfloat16).  Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for an hd or dtype it lacks.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KV, int Sq, int Skv,
                           int hd, int dtype, long long qsb, long long qsh,
                           long long qss, long long ksb, long long ksh,
                           long long kss, long long vsb, long long vsh,
                           long long vss, long long osb, long long osh,
                           long long oss, int causal, int window, float scale,
                           void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, KV, Sq, Skv, hd, qs, ks, vs, os,
                           causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Skv, hd, qs, ks,
                                   vs, os, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
