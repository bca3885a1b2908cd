// Single-token GQA decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/decode_attention/kernel.py::
// decode_attention (body `_kernel`): one query token per (batch row, query
// head) against a (B, L, KV, hd) cache under a (B, L) validity mask, query
// head h reading KV head h / (H / KV), softmax over the cache in float32 and
// the output in the query's dtype.  Scores are (q * scale) . k with q cast to
// float32 first; scale defaults to hd^-0.5 in the wrapper (the decoder
// scales q in its compute dtype itself and passes 1).  Masked slots score
// -1e30, as in the plain version ../ref.py, so a row whose every slot is
// masked averages v over the L real slots (the Pallas kernel also weighs in
// its padding there); the decoder never makes such a row.
//
// Design.  On the TPU the cache streams through VMEM in blocks of L along a
// sequential grid axis, with (m, l, acc) carried in scratch.  Here that axis
// is a loop inside one block per (b, kv head), which holds all G = H / KV
// query heads of the group, so each K and V row is read from device memory
// once per group, not once per query head.  Per tile of kTile cache rows:
// the V tile is staged in shared memory as float32; one warp per cache row
// reads its K row straight into registers (hd / 32 values a lane) and
// reduces its dot product with every query head of the group by shuffles;
// one warp per query head then runs the online-softmax update (m, l, alpha)
// over the tile's scores; last, each thread folds the tile into its own
// slice of the (G, hd) float32 accumulator, kept in registers.  bf16 and
// float32 inputs, float32 arithmetic throughout (FMA, no tensor cores).
//
// Bound.  Decode reads the whole cache once and does 4 hd flops per
// (query head, slot): at G = 1 (Phi-3-mini, MHA) that is 1 flop per bf16
// byte, so device-memory bytes bound it by two orders of magnitude.  What
// this simple design leaves on the table: a block loads its tile with plain
// per-thread loads and no copy in flight while it computes, and at small
// B * KV (a GQA config at batch 1 gives 8 blocks on 132 SMs) most of the
// card idles.  Splitting L over several blocks with a merge pass
// (flash-decoding) and cp.async/TMA staging are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;             // cache rows per step of the L loop
constexpr int kMaxAcc = 32;           // accumulator entries per thread
constexpr float kNeg = -1e30f;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_bytes(int G, int hd) {
  return sizeof(float) *
         ((size_t)G * hd + (size_t)kTile * hd + (size_t)G * kTile + 3 * G);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const uint8_t* __restrict__ valid,
                        T* __restrict__ out, int H, int KV, int L,
                        float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kPerLane = HD / 32;
  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  float* qs = smem;                       // G x HD, scaled
  float* vs = qs + G * HD;                // kTile x HD
  float* ps = vs + kTile * HD;            // G x kTile: scores, then weights
  float* m_s = ps + G * kTile;            // running max per query head
  float* l_s = m_s + G;                   // running denominator
  float* a_s = l_s + G;                   // this tile's rescale factor

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_acc = G * HD;
  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * HD;
  for (int i = tid; i < n_acc; i += kThreads) qs[i] = to_f(qb[i]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;
  __syncthreads();

  const size_t row = (size_t)KV * HD;     // elements between cache rows
  const T* kb = k + (size_t)b * L * row + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * L * row + (size_t)kvh * HD;
  const uint8_t* valb = valid + (size_t)b * L;

  for (int l0 = 0; l0 < L; l0 += kTile) {
    const int n = min(kTile, L - l0);
    for (int i = tid; i < n * HD; i += kThreads) {
      const int t = i / HD, d = i - t * HD;
      vs[i] = to_f(vb[(size_t)(l0 + t) * row + d]);
    }
    for (int t = warp; t < n; t += kWarps) {
      const T* kr = kb + (size_t)(l0 + t) * row;
      float kv[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) kv[j] = to_f(kr[lane + 32 * j]);
      const bool ok = valb[l0 + t] != 0;
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          s = fmaf(qs[g * HD + lane + 32 * j], kv[j], s);
        s = warp_sum(s);
        if (lane == 0) ps[g * kTile + t] = ok ? s : kNeg;
      }
    }
    __syncthreads();
    // online softmax over the tile; slots past L weigh nothing
    for (int g = warp; g < G; g += kWarps) {
      float* pg = ps + g * kTile;
      const float s0 = lane < n ? pg[lane] : -CUDART_INF_F;
      const float s1 = lane + 32 < n ? pg[lane + 32] : -CUDART_INF_F;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      pg[lane] = p0;
      pg[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int e = tid + r * kThreads;
      if (e < n_acc) {
        const int g = e / HD, d = e - g * HD;
        const float* pg = ps + g * kTile;
        float a = acc[r] * a_s[g];
        for (int t = 0; t < n; ++t) a = fmaf(pg[t], vs[t * HD + d], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * H + (size_t)kvh * G) * HD;
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int e = tid + r * kThreads;
    if (e < n_acc) ob[e] = from_f<T>(acc[r] / fmaxf(l_s[e / HD], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           void* out, int B, int H, int KV, int L, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, HD);
  auto kern = decode_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(out), H, KV, L, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v,
             const uint8_t* valid, void* out, int B, int H, int KV, int L,
             int hd, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, valid, out, B, H, KV, L, scale, s);
    case 64: return launch<T, 64>(q, k, v, valid, out, B, H, KV, L, scale, s);
    case 96: return launch<T, 96>(q, k, v, valid, out, B, H, KV, L, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, valid, out, B, H, KV, L, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest G * hd (query heads of a group times head width) one block holds.
int decode_attention_max_group_width() { return kMaxAcc * kThreads; }

// One launch on `stream`: q (B, H, hd), k and v (B, L, KV, hd), all
// contiguous of one dtype (0 = float32, 1 = bfloat16); valid (B, L) bytes;
// out (B, H, hd) of q's dtype.  Returns cudaGetLastError() after it
// (0 = launched), or cudaErrorInvalidValue for an hd or dtype it lacks.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const uint8_t* valid, void* out, int B, int H,
                            int KV, int L, int hd, int dtype, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, valid, out, B, H, KV, L, hd, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, valid, out, B, H, KV, L, hd,
                                   scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
