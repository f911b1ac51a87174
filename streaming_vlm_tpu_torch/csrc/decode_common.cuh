// Shared parts of the port's split-K decode kernels (K2 and K4 in
// decode_attention.cu, K3 in decode_attention_raw.cu, K2-verify in
// verify_attention.cu): the constants, the warp reductions, and the end of
// every part: its partial written (`store_partial`), then the fused combine
// by the last CTA of each kv head (`arrive_last`, `fold_parts`; the three
// in turn are `finish_part`).
//
// Lanes: a call may cover B independent streams (grid axis z), each with
// its own visible length, read from an int32 device array. A (lane, kv
// head) pair is a `head` = lane * Hkv + kv head of the scratch.
//
// Partial layout, written by every part: part_m / part_l [B * Hkv, stride,
// G] and part_acc [B * Hkv, stride, G, HD], all f32, log2-space (q is
// pre-scaled by softmax-scale * log2(e)), unnormalised; `stride` is the
// grid's part count, and a lane's n_parts <= stride parts fill slots [0,
// n_parts). counters [B * Hkv] int32 are zero between calls: the folding
// CTA resets its head's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 128;
constexpr int GMAX = 8;        // largest GQA group the kernels take
constexpr int EMAX = 256;      // largest k_small row count
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DEC_THREADS = 256;                // a split CTA: 8 warps
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int QUARTERS = DEC_THREADS / (HD / 2);  // P.V: 64 threads of 2 head dims each per quarter

static_assert(QUARTERS == 4 && GMAX <= DEC_WARPS, "the layouts below assume these");

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

// The visible length of lane `lane`: from the device array when there is
// one (the lane form), else the host's value, at most the slots the grid's
// `max_rows` cover (a longer length is a caller's error; this keeps every
// partial inside its head's slots).
__device__ __forceinline__ int lane_visible(const int* __restrict__ vis_lanes, int vis_host,
                                            int lane, int max_rows) {
  return min(vis_lanes != nullptr ? vis_lanes[lane] : vis_host, max_rows);
}

// One step of a transposing warp reduction: lanes that differ in bit OFF
// swap halves of their first 2 OFF values and add, so that after the steps
// 16, 8, 4, 2, 1 lane l holds the warp's sum of value l (K2, K2-verify).
template <int OFF>
__device__ __forceinline__ void butterfly(float (&v)[32], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// A part's partial, called by all DEC_THREADS threads of its CTA. acc holds
// this thread's P.V sums (head dims 2 (tid % 64) + {0, 1} of its quarter's
// rows); s_m / s_l the part's running max and sum per query head. The
// quarters meet in `red` (QUARTERS * GMAX * HD floats) and the partial goes
// to slot `part` of head `head`'s `stride` slots.
__device__ __forceinline__ void store_partial(
    const float (&acc)[GMAX][2], float* red, const float* s_m, const float* s_l,
    float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc,
    int head, int part, int stride, int G) {
  const int tid = threadIdx.x;
  const int dp = tid % (HD / 2), quarter = tid / (HD / 2);
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      *reinterpret_cast<float2*>(red + (quarter * GMAX + g) * HD + 2 * dp) =
          make_float2(acc[g][0], acc[g][1]);
    }
  }
  __syncthreads();
  const size_t base = ((size_t)head * stride + part) * G;
  for (int i = tid; i < G * HD; i += DEC_THREADS) {
    const int g = i / HD, d = i % HD;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < QUARTERS; ++k) a += red[(k * GMAX + g) * HD + d];
    part_acc[base * HD + i] = a;
  }
  if (tid < G) {
    part_m[base + tid] = s_m[tid];
    part_l[base + tid] = s_l[tid];
  }
}

// Count the CTA in on counter `counter` after its partials are written;
// true in the last of n_parts CTAs to arrive (every thread of it).
__device__ __forceinline__ bool arrive_last(int* __restrict__ counters, int counter,
                                            int n_parts, int* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(&counters[counter], 1) == n_parts - 1;
  __syncthreads();
  if (!*s_last) return false;
  __threadfence();
  return true;
}

// The fused combine of head `head`'s n_parts partials, in the last CTA to
// arrive: one coalesced pass brings every part's (m, l) into shared memory,
// the partial rows fold in parallel (each quarter of the threads a strided
// subset of the parts), and the output is written (FULL: the normalised
// bf16 row per query head of kv head kvh, `out` being the lane's [H, HD];
// else the merged partials m_out, l_out, acc_out). buf_a and buf_b hold
// max(QUARTERS * GMAX * HD, n_parts * G) floats each; s_m, s_den GMAX
// floats each.
template <bool FULL>
__device__ __forceinline__ void fold_parts(
    float* buf_a, float* buf_b, float* s_m, float* s_den, const float* __restrict__ part_m,
    const float* __restrict__ part_l, const float* __restrict__ part_acc,
    bf16* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ acc_out, int head, int kvh, int n_parts, int stride, int G) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dp = tid % (HD / 2), quarter = tid / (HD / 2);
  // query head g's weights and denominator are warp g's
  float* w = buf_a;   // [n_parts][G] maxima, then weights
  float* pl = buf_b;  // [n_parts][G]
  for (int i = tid; i < n_parts * G; i += DEC_THREADS) {
    w[i] = __ldcg(part_m + (size_t)head * stride * G + i);
    pl[i] = __ldcg(part_l + (size_t)head * stride * G + i);
  }
  __syncthreads();
  if (warp < G) {
    const int g = warp;
    float mx = -INFINITY;
    for (int p = lane; p < n_parts; p += 32) mx = fmaxf(mx, w[p * G + g]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int p = lane; p < n_parts; p += 32) {
      const float m = w[p * G + g];
      const float wt = m == -INFINITY ? 0.f : exp2f(m - mx);
      w[p * G + g] = wt;
      den += wt * pl[p * G + g];
    }
    den = warp_sum(den);
    if (lane == 0) {
      s_m[g] = mx;
      s_den[g] = den;
    }
  }
  __syncthreads();
  float a[GMAX][2];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) a[g][0] = a[g][1] = 0.f;
#pragma unroll 4
  for (int p = quarter; p < n_parts; p += QUARTERS) {
    const float* pa = part_acc + ((size_t)head * stride + p) * G * HD + 2 * dp;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float2 x = __ldcg(reinterpret_cast<const float2*>(pa + g * HD));
        const float wt = w[p * G + g];
        a[g][0] += wt * x.x;
        a[g][1] += wt * x.y;
      }
    }
  }
  __syncthreads();  // the denominators' inputs in buf_b are read
  float* red2 = buf_b;  // [QUARTERS][GMAX][HD]
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      *reinterpret_cast<float2*>(red2 + (quarter * GMAX + g) * HD + 2 * dp) =
          make_float2(a[g][0], a[g][1]);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += DEC_THREADS) {
    const int g = i / HD, d = i % HD;
    float x = 0.f;
#pragma unroll
    for (int k = 0; k < QUARTERS; ++k) x += red2[(k * GMAX + g) * HD + d];
    const size_t o = ((size_t)kvh * G + g) * HD + d;
    if constexpr (FULL) {
      out[o] = __float2bfloat16(x / fmaxf(s_den[g], 1e-20f));
    } else {
      acc_out[o] = x;
    }
  }
  if constexpr (!FULL) {
    if (tid < G) {
      m_out[kvh * G + tid] = s_m[tid];
      l_out[kvh * G + tid] = s_den[tid];
    }
  }
}

// The end of a part (K2, K3, K4), called by all DEC_THREADS threads of its
// CTA: its partial stored (the quarters meet in buf_a), the CTA counted in
// on its head's counter (head = lane * Hkv + kvh), and in the last of the
// head's n_parts CTAs to arrive the fused combine (`fold_parts`), which
// then resets the counter for the next call.
template <bool FULL>
__device__ __forceinline__ void finish_part(
    const float (&acc)[GMAX][2], float* buf_a, float* buf_b, float* s_m, const float* s_l,
    float* s_den, int* s_last, float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int* __restrict__ counters, bf16* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out, int head,
    int kvh, int part, int n_parts, int stride, int G) {
  store_partial(acc, buf_a, s_m, s_l, part_m, part_l, part_acc, head, part, stride, G);
  if (!arrive_last(counters, head, n_parts, s_last)) return;
  fold_parts<FULL>(buf_a, buf_b, s_m, s_den, part_m, part_l, part_acc, out, m_out, l_out,
                   acc_out, head, kvh, n_parts, stride, G);
  if (threadIdx.x == 0) counters[head] = 0;  // ready for the next call
}

}  // namespace
