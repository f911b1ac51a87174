// Single-token decode attention over the pre-rotated arena + the decode
// delta + the token's own row, under one joint softmax (kernel K2 of the
// port).
//
// Replaces the TPU kernel streaming_vlm_tpu/ops/attention.py
// `streaming_decode_attention_full` / `_decode_full_kernel`. Three parts
// share one softmax: arena slots < visible_len, delta rows
// k_small[:e_delta] below extra_visible, and the always-visible self rows
// k_small[e_delta:].
//
// What bounds it on an H100: bytes. One token reads every visible arena
// slot's K and V once: 28 layers x 10240 slots x 4 kv heads x 128 x 2 B x 2
// ~ 587 MB per decode token at 7B, against ~0.3 GFLOP of math. The design
// spreads that read over the whole card (split-K flash decoding):
//   * pass 1, grid (kv head, arena splits / 4): each warp owns one split of
//     SPLIT=64 consecutive visible slots, one slot per lane for Q.K (the
//     lane reads its key's 256-byte row; the G queries of the kv head sit
//     in shared memory as f32 and are read by broadcast), then one head-dim
//     slice per lane for P.V (coalesced row reads). It writes the split's
//     partial (m, l, acc) in log2 space to scratch the wrapper allocates.
//     Splits end at visible_len: slots past it are never read;
//   * pass 2, one CTA per query head, folds the splits and the small
//     delta + self rows into the final softmax and writes its [HD] row.
// q stays in f32 (scaled by softmax-scale * log2(e)); sums are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int HD = 128;
constexpr int GMAX = 8;        // largest GQA group the kernels take
constexpr int SPLIT = 64;      // arena slots per warp in pass 1
constexpr int EMAX = 256;      // largest k_small row count
constexpr int THREADS = 128;   // 4 warps; pass 2 maps one thread per head-dim lane

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

__device__ __forceinline__ void load_q(float* sq, const bf16* __restrict__ q, int kvh,
                                       int G, float qscale) {
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    sq[i] = __bfloat162float(q[(size_t)kvh * G * HD + i]) * qscale;
  }
}

__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const bf16* __restrict__ q,    // [H, HD]
    const bf16* __restrict__ ka,   // [C, Hkv, HD] pre-rotated
    const bf16* __restrict__ va,   // [C, Hkv, HD]
    float* __restrict__ part_m,    // [Hkv, n_splits, G]
    float* __restrict__ part_l,    // [Hkv, n_splits, G]
    float* __restrict__ part_acc,  // [Hkv, n_splits, G, HD]
    int Hkv, int G, int visible_len, int n_splits, float qscale) {
  __shared__ __align__(16) float sq[GMAX * HD];
  const int kvh = blockIdx.x;
  load_q(sq, q, kvh, G, qscale);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int split = blockIdx.y * (THREADS / 32) + warp;
  if (split >= n_splits) return;
  const int c_lo = split * SPLIT;
  const int c_hi = min(c_lo + SPLIT, visible_len);

  float m[GMAX], l[GMAX], acc[GMAX][4];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  }

  for (int c0 = c_lo; c0 < c_hi; c0 += 32) {
    // logits: lane = key
    const int c = c0 + lane;
    const bool valid = c < c_hi;
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    if (valid) {
      const uint4* row = reinterpret_cast<const uint4*>(ka + ((size_t)c * Hkv + kvh) * HD);
#pragma unroll 4
      for (int j = 0; j < HD / 8; ++j) {
        const uint4 u = row[j];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        float kf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(h[e]);
          kf[2 * e] = x.x;
          kf[2 * e + 1] = x.y;
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            const float4 qa = *reinterpret_cast<const float4*>(sq + g * HD + j * 8);
            const float4 qb = *reinterpret_cast<const float4*>(sq + g * HD + j * 8 + 4);
            s[g] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                    qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
          }
        }
      }
    }
    float p[GMAX];
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
    // P.V: lane owns head-dim slice [4*lane, 4*lane + 4); unrolled so that
    // several V rows are in flight
    const int n = min(32, c_hi - c0);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const uint2 u = *reinterpret_cast<const uint2*>(
          va + ((size_t)(c0 + j) * Hkv + kvh) * HD + 4 * lane);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 v01 = __bfloat1622float2(h[0]);
      const float2 v23 = __bfloat1622float2(h[1]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float pj = __shfl_sync(0xffffffffu, p[g], j);
          acc[g][0] += pj * v01.x;
          acc[g][1] += pj * v01.y;
          acc[g][2] += pj * v23.x;
          acc[g][3] += pj * v23.y;
        }
      }
    }
  }

  const size_t base = ((size_t)kvh * n_splits + split) * G;
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
  for (int j = warp; j < e1; j += THREADS / 32) {
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

}  // namespace

// Scratch part_m / part_l / part_acc hold n_splits = ceil(visible_len /
// SPLIT) splits; the wrapper allocates them (svt_decode_split_size gives
// SPLIT) and may pass null pointers when visible_len == 0.
extern "C" int svt_decode_split_size() { return SPLIT; }

extern "C" int svt_decode_max_small_rows() { return EMAX; }

extern "C" int svt_decode_attention(
    const void* q, const void* ka, const void* va, const void* ksm,
    const void* vsm, void* part_m, void* part_l, void* part_acc, void* out,
    int H, int Hkv, int hd, int e1, int e_delta, int visible_len,
    int extra_visible, void* stream) {
  if (hd != HD || H % Hkv != 0 || H / Hkv > GMAX || e1 > EMAX || e1 <= e_delta) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = H / Hkv;
  const float qscale = 1.4426950408889634f / sqrtf((float)hd);
  const int n_splits = (visible_len + SPLIT - 1) / SPLIT;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_splits > 0) {
    const dim3 grid(Hkv, (n_splits + THREADS / 32 - 1) / (THREADS / 32));
    decode_split_kernel<<<grid, THREADS, 0, s>>>(
        (const bf16*)q, (const bf16*)ka, (const bf16*)va, (float*)part_m,
        (float*)part_l, (float*)part_acc, Hkv, G, visible_len, n_splits, qscale);
  }
  const size_t dyn = sizeof(float) * (size_t)n_splits;
  if (dyn > 40 * 1024) {  // static shared memory takes ~1.5 KB of the default 48
    cudaFuncSetAttribute(decode_combine_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  }
  decode_combine_kernel<<<dim3(Hkv, G), THREADS, dyn, s>>>(
      (const bf16*)q, (const bf16*)ksm, (const bf16*)vsm, (const float*)part_m,
      (const float*)part_l, (const float*)part_acc, (bf16*)out, Hkv, G, n_splits,
      e1, e_delta, extra_visible, qscale);
  return (int)cudaGetLastError();
}
