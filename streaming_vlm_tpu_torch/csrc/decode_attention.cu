// Single-token decode attention over the pre-rotated arena: kernel K2 of
// the port (arena + decode delta + self under one joint softmax) and kernel
// K4 (the arena's log2-space partials alone).
//
// K2 replaces the TPU kernel streaming_vlm_tpu/ops/attention.py
// `streaming_decode_attention_full` / `_decode_full_kernel`. Three parts
// share one softmax: arena slots < visible_len, delta rows
// k_small[:e_delta] below extra_visible, and the always-visible self rows
// k_small[e_delta:].
//
// K4 replaces `streaming_decode_attention` / `_decode_kernel`, the JAX
// package's test-only cross-check of K2: the same split pass, then a
// combine that returns the merged unnormalised partials (m [H], l [H], acc
// [H, HD], log2 space) instead of dividing. At visible_len == 0 it returns
// m = -1e30, l = 0, acc = 0, as the TPU kernel does.
//
// What bounds them on an H100: bytes. One token reads every visible arena
// slot's K and V once: 28 layers x 10240 slots x 4 kv heads x 128 x 2 B x 2
// ~ 587 MB per decode token at 7B, against ~0.3 GFLOP of math. The design
// spreads that read over the whole card (split-K flash decoding):
//   * split pass, grid (kv head, arena splits / 4): each warp owns one split
//     of SPLIT=64 consecutive visible slots, one slot per lane for Q.K (the
//     lane reads its key's 256-byte row; the G queries of the kv head sit
//     in shared memory as f32 and are read by broadcast), then one head-dim
//     slice per lane for P.V (coalesced row reads). It writes the split's
//     partial (m, l, acc) in log2 space to scratch the wrapper allocates.
//     Splits end at visible_len: slots past it are never read;
//   * K2's combine (decode_common.cuh), one CTA per query head, folds the
//     splits and the small delta + self rows into the final softmax and
//     writes its [HD] row; K4's folds the splits alone into partials.
// q stays in f32 (scaled by softmax-scale * log2(e)); sums are f32.

#include "decode_common.cuh"

namespace {

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
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    sq[i] = __bfloat162float(q[(size_t)kvh * G * HD + i]) * qscale;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int split = blockIdx.y * NWARPS + warp;
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
    online_softmax_step(s, valid, G, m, l, acc, p);
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

  store_partials(part_m, part_l, part_acc, ((size_t)kvh * n_splits + split) * G, G, m, l,
                 acc, lane);
}

// K4's combine: one CTA per (kv head, query head of its group), thread d
// owns head-dim d; folds the splits into merged partials without dividing.
__global__ void __launch_bounds__(THREADS) decode_partials_combine_kernel(
    const float* __restrict__ part_m,    // [Hkv, n_splits, G]
    const float* __restrict__ part_l,
    const float* __restrict__ part_acc,  // [Hkv, n_splits, G, HD]
    float* __restrict__ m_out,           // [H]
    float* __restrict__ l_out,           // [H]
    float* __restrict__ acc_out,         // [H, HD]
    int G, int n_splits) {
  __shared__ float s_mx;
  __shared__ float s_l;
  extern __shared__ float s_w[];  // [n_splits] split maxima, then weights
  const int kvh = blockIdx.x;
  const int g = blockIdx.y;
  const int h = kvh * G + g;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x; s < n_splits; s += THREADS) {
    s_w[s] = part_m[((size_t)kvh * n_splits + s) * G + g];
  }
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
    for (int s = lane; s < n_splits; s += 32) mx = fmaxf(mx, s_w[s]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float w = exp2f(s_w[s] - mx);
      s_w[s] = w;
      l += w * part_l[((size_t)kvh * n_splits + s) * G + g];
    }
    l = warp_sum(l);
    if (lane == 0) {
      s_mx = mx;
      s_l = l;
    }
  }
  __syncthreads();
  const int d = threadIdx.x;  // THREADS == HD
  float a = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_splits; ++s) {
    a += s_w[s] * part_acc[(((size_t)kvh * n_splits + s) * G + g) * HD + d];
  }
  acc_out[(size_t)h * HD + d] = a;
  if (d == 0) {
    m_out[h] = s_mx;
    l_out[h] = s_l;
  }
}

__global__ void decode_partials_empty_kernel(float* m_out, float* l_out, float* acc_out,
                                             int H) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < H * HD;
       i += gridDim.x * blockDim.x) {
    acc_out[i] = 0.f;
    if (i < H) {
      m_out[i] = -1e30f;
      l_out[i] = 0.f;
    }
  }
}

void launch_split(const void* q, const void* ka, const void* va, void* part_m,
                  void* part_l, void* part_acc, int Hkv, int G, int visible_len,
                  int n_splits, float qscale, cudaStream_t s) {
  const dim3 grid(Hkv, (n_splits + NWARPS - 1) / NWARPS);
  decode_split_kernel<<<grid, THREADS, 0, s>>>(
      (const bf16*)q, (const bf16*)ka, (const bf16*)va, (float*)part_m, (float*)part_l,
      (float*)part_acc, Hkv, G, visible_len, n_splits, qscale);
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
  const float qscale = LOG2E / sqrtf((float)hd);
  const int n_splits = (visible_len + SPLIT - 1) / SPLIT;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_splits > 0) {
    launch_split(q, ka, va, part_m, part_l, part_acc, Hkv, G, visible_len, n_splits, qscale,
                 s);
  }
  launch_decode_combine((const bf16*)q, (const bf16*)ksm, (const bf16*)vsm,
                        (const float*)part_m, (const float*)part_l, (const float*)part_acc,
                        (bf16*)out, Hkv, G, n_splits, e1, e_delta, extra_visible, qscale, s);
  return (int)cudaGetLastError();
}

// K4: merged log2-space partials of one token over arena slots < visible_len.
extern "C" int svt_decode_partials(
    const void* q, const void* ka, const void* va, void* part_m, void* part_l,
    void* part_acc, void* m_out, void* l_out, void* acc_out, int H, int Hkv, int hd,
    int visible_len, void* stream) {
  if (hd != HD || H % Hkv != 0 || H / Hkv > GMAX) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  const float qscale = LOG2E / sqrtf((float)hd);
  const int n_splits = (visible_len + SPLIT - 1) / SPLIT;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_splits == 0) {
    decode_partials_empty_kernel<<<(H * HD + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        (float*)m_out, (float*)l_out, (float*)acc_out, H);
    return (int)cudaGetLastError();
  }
  launch_split(q, ka, va, part_m, part_l, part_acc, Hkv, G, visible_len, n_splits, qscale, s);
  const size_t dyn = sizeof(float) * (size_t)n_splits;
  if (dyn > 40 * 1024) {
    cudaFuncSetAttribute(decode_partials_combine_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  }
  decode_partials_combine_kernel<<<dim3(Hkv, G), THREADS, dyn, s>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc, (float*)m_out,
      (float*)l_out, (float*)acc_out, G, n_splits);
  return (int)cudaGetLastError();
}
