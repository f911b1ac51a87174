// Shared parts of the port's split-K decode kernels (K2 and K4 in
// decode_attention.cu, K3 in decode_attention_raw.cu): the constants, the
// warp reductions, and the combine pass that folds the per-split partials
// and the small delta + self block into the final softmax.
//
// Partial layout, written by every split pass: part_m / part_l [Hkv,
// n_splits, G] and part_acc [Hkv, n_splits, G, HD], all f32, log2-space
// (q is pre-scaled by softmax-scale * log2(e)), unnormalised; split s covers
// arena slots [s * SPLIT, min((s + 1) * SPLIT, visible_len)).
//
// Each .cu file includes this header and gets its own copy of these
// internal-linkage kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 128;
constexpr int HALF = HD / 2;
constexpr int GMAX = 8;        // largest GQA group the kernels take
constexpr int SPLIT = 64;      // arena slots per split
constexpr int EMAX = 256;      // largest k_small row count
constexpr int THREADS = 128;   // 4 warps; the combine maps one thread per head-dim lane
constexpr int NWARPS = THREADS / 32;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One online-softmax step of a warp over 32 keys (lane = key): fold the
// logits s[g] (invalid lanes masked) into the running (m, l, acc) and return
// the weights p[g] that P.V multiplies (0 for invalid lanes).
__device__ __forceinline__ void online_softmax_step(const float* s, bool valid, int G,
                                                    float* m, float* l, float (*acc)[4],
                                                    float* p) {
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      const float sg = valid ? s[g] : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(sg));
      p[g] = valid ? exp2f(sg - m_new) : 0.f;
      const float alpha = (m[g] == -INFINITY) ? 0.f : exp2f(m[g] - m_new);
      l[g] = l[g] * alpha + warp_sum(p[g]);
      acc[g][0] *= alpha;
      acc[g][1] *= alpha;
      acc[g][2] *= alpha;
      acc[g][3] *= alpha;
      m[g] = m_new;
    } else {
      p[g] = 0.f;
    }
  }
}

// Write one warp's split partials (lane owns head-dim slice [4*lane, 4*lane+4)).
__device__ __forceinline__ void store_partials(float* __restrict__ part_m,
                                               float* __restrict__ part_l,
                                               float* __restrict__ part_acc, size_t base,
                                               int G, const float* m, const float* l,
                                               float (*acc)[4], int lane) {
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        part_m[base + g] = m[g];
        part_l[base + g] = l[g];
      }
      *reinterpret_cast<float4*>(part_acc + (base + g) * HD + 4 * lane) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS) decode_combine_kernel(
    const bf16* __restrict__ q,         // [H, HD]
    const bf16* __restrict__ ksm,       // [E1, Hkv, HD] rotated delta ++ self rows
    const bf16* __restrict__ vsm,       // [E1, Hkv, HD]
    const float* __restrict__ part_m,   // [Hkv, n_splits, G]
    const float* __restrict__ part_l,
    const float* __restrict__ part_acc, // [Hkv, n_splits, G, HD]
    bf16* __restrict__ out,             // [H, HD]
    int Hkv, int G, int n_splits, int e1, int e_delta, int extra_visible,
    float qscale) {
  // one CTA per (kv head, query head of its group); thread d owns head-dim d
  __shared__ __align__(16) float sq[HD];
  __shared__ float s_small[EMAX];  // small-part logits, then softmax weights
  __shared__ float s_den;
  extern __shared__ float s_w[];   // [n_splits] split maxima, then weights
  const int kvh = blockIdx.x;
  const int g = blockIdx.y;
  const int h = kvh * G + g;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < HD; d += THREADS) {
    sq[d] = __bfloat162float(q[(size_t)h * HD + d]) * qscale;
  }
  for (int s = threadIdx.x; s < n_splits; s += THREADS) {
    s_w[s] = part_m[((size_t)kvh * n_splits + s) * G + g];
  }
  __syncthreads();

  // small-part logits: one row per warp iteration
  for (int j = warp; j < e1; j += NWARPS) {
    const bf16* row = ksm + ((size_t)j * Hkv + kvh) * HD;
    float part = 0.f;
#pragma unroll
    for (int d = lane; d < HD; d += 32) part += sq[d] * __bfloat162float(row[d]);
    part = warp_sum(part);
    if (lane == 0) {
      const bool vis = j < extra_visible || j >= e_delta;
      s_small[j] = vis ? part : -INFINITY;
    }
  }
  __syncthreads();

  // joint max, weights and denominator (warp 0; each lane owns its indices)
  if (warp == 0) {
    float mx = -INFINITY;
    for (int s = lane; s < n_splits; s += 32) mx = fmaxf(mx, s_w[s]);
    for (int j = lane; j < e1; j += 32) mx = fmaxf(mx, s_small[j]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float m = s_w[s];
      const float w = (m == -INFINITY) ? 0.f : exp2f(m - mx);
      s_w[s] = w;
      den += w * part_l[((size_t)kvh * n_splits + s) * G + g];
    }
    for (int j = lane; j < e1; j += 32) {
      const float sj = s_small[j];
      const float w = (sj == -INFINITY) ? 0.f : exp2f(sj - mx);
      s_small[j] = w;
      den += w;
    }
    den = warp_sum(den);
    if (lane == 0) s_den = fmaxf(den, 1e-20f);
  }
  __syncthreads();

  const int d = threadIdx.x;  // THREADS == HD
  float a = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_splits; ++s) {
    a += s_w[s] * part_acc[(((size_t)kvh * n_splits + s) * G + g) * HD + d];
  }
  for (int j = 0; j < e1; ++j) {
    a += s_small[j] * __bfloat162float(vsm[((size_t)j * Hkv + kvh) * HD + d]);
  }
  out[(size_t)h * HD + d] = __float2bfloat16(a / s_den);
}

// Launch the combine pass on `stream` (dynamic shared memory holds one float
// per split).
inline void launch_decode_combine(const bf16* q, const bf16* ksm, const bf16* vsm,
                                  const float* part_m, const float* part_l,
                                  const float* part_acc, bf16* out, int Hkv, int G,
                                  int n_splits, int e1, int e_delta, int extra_visible,
                                  float qscale, cudaStream_t s) {
  const size_t dyn = sizeof(float) * (size_t)n_splits;
  if (dyn > 40 * 1024) {  // static shared memory takes ~1.5 KB of the default 48
    cudaFuncSetAttribute(decode_combine_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  }
  decode_combine_kernel<<<dim3(Hkv, G), THREADS, dyn, s>>>(
      q, ksm, vsm, part_m, part_l, part_acc, out, Hkv, G, n_splits, e1, e_delta,
      extra_visible, qscale);
}

}  // namespace
