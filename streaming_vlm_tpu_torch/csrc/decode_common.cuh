// Shared parts of the port's split-K decode kernels (K2 and K4 in
// decode_attention.cu, K3 in decode_attention_raw.cu): the constants and the
// warp reductions.
//
// Partial layout, written by every split pass: part_m / part_l [Hkv,
// n_parts, G] and part_acc [Hkv, n_parts, G, HD], all f32, log2-space (q is
// pre-scaled by softmax-scale * log2(e)), unnormalised.

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

}  // namespace
