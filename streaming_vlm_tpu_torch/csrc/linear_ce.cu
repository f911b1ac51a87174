// The row pass of the fused linear cross-entropy (kernel CE-row of the
// port): over one chunk's f32 logits [rows, V], each row's masked NLL and,
// for the gradient, dlog = (softmax - onehot(target)) * mask written in place
// over the logits, in one launch.
//
// It replaces no pl.pallas_call: the JAX package computes this pass in XLA
// inside `fused_linear_ce`'s custom_vjp (streaming_vlm_tpu/train/step.py:
// 61-72, `_fused_ce_pass`). Its plain form there and in PyTorch makes ~6
// passes over the chunk (max, x - max, exp, sum, the divide, the onehot
// subtract and the mask), each over a 1.25 GB f32 chunk at the 7B
// vocabulary (2048 rows x 152064).
//
// What bounds it on an H100: bytes. The least it can move is one read of
// the logits and, with the gradient, one write of dlog: 2 x 1.25 GB, 0.74 ms
// at 3.35 TB/s (one read alone without it, 0.37 ms). What the design does:
//   * one CTA a row (1024 threads, 16-byte loads): a first sweep keeps each
//     thread's running (max, sum of exp(x - max)) online, rescaling the sum
//     when the max grows, and reduces them over the block; the row's target
//     logit is read once; a second sweep, with the gradient, re-reads the
//     row (from L2 where it is still there) and writes exp(x - max) / sum,
//     minus 1 at the target, times the mask, over it. So the row is read
//     twice and written once, where the plain form reads it ~6 times;
//   * expf and logf, not their fast approximations: dlog is held to 1e-5
//     of each value (probabilities down to ~1e-17 included) and the NLL to
//     1e-5 relative against the plain f32 pass;
//   * a masked row (the prompt's tokens) is not read: its NLL is 0 and its
//     dlog row is written as zeros.
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3): 1.06 ms of
// device time on [2048, 152064] with a quarter of the rows masked, against
// its 0.65 ms byte bound.
//
// Built by nvcc for sm_90a into the port's plain-C shared library (see
// streaming_vlm_tpu_torch/ops/_kernels.py); the entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

// (m, s) <- the merge of two running (max, sum of exp(x - max))
__device__ __forceinline__ void merge_ms(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void add_x(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

__global__ void __launch_bounds__(THREADS) ce_rows_kernel(float* __restrict__ logits,
                                                          const int* __restrict__ targets,
                                                          const float* __restrict__ mask,
                                                          float* __restrict__ nll, long long V,
                                                          int with_grads) {
  __shared__ float s_m[WARPS], s_s[WARPS];
  const long long row = blockIdx.x;
  float* x = logits + row * V;
  const float mk = mask[row];
  const bool vec = V % 4 == 0;  // rows 16-byte aligned: the pointer is, and V % 4 == 0
  if (mk == 0.f) {
    if (threadIdx.x == 0) nll[row] = 0.f;
    if (with_grads) {
      if (vec) {
        for (long long i = threadIdx.x; i < V / 4; i += THREADS)
          reinterpret_cast<float4*>(x)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (long long i = threadIdx.x; i < V; i += THREADS) x[i] = 0.f;
      }
    }
    return;
  }
  float m = -INFINITY, s = 0.f;
  if (vec) {
    for (long long i = threadIdx.x; i < V / 4; i += THREADS) {
      const float4 v = reinterpret_cast<const float4*>(x)[i];
      add_x(m, s, v.x);
      add_x(m, s, v.y);
      add_x(m, s, v.z);
      add_x(m, s, v.w);
    }
  } else {
    for (long long i = threadIdx.x; i < V; i += THREADS) add_x(m, s, x[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge_ms(m, s, m2, s2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_m[warp] = m;
    s_s[warp] = s;
  }
  __syncthreads();
  m = s_m[0];
  s = s_s[0];
  for (int w = 1; w < WARPS; ++w) merge_ms(m, s, s_m[w], s_s[w]);  // every thread, in one order
  const int tgt = targets[row];
  if (threadIdx.x == 0) nll[row] = (logf(s) + m - x[tgt]) * mk;
  if (!with_grads) return;
  __syncthreads();  // the target logit is read before it is overwritten
  if (vec) {
    for (long long i = threadIdx.x; i < V / 4; i += THREADS) {
      float4 v = reinterpret_cast<const float4*>(x)[i];
      const long long j = 4 * i;
      v.x = (expf(v.x - m) / s - (j == tgt ? 1.f : 0.f)) * mk;
      v.y = (expf(v.y - m) / s - (j + 1 == tgt ? 1.f : 0.f)) * mk;
      v.z = (expf(v.z - m) / s - (j + 2 == tgt ? 1.f : 0.f)) * mk;
      v.w = (expf(v.w - m) / s - (j + 3 == tgt ? 1.f : 0.f)) * mk;
      reinterpret_cast<float4*>(x)[i] = v;
    }
  } else {
    for (long long i = threadIdx.x; i < V; i += THREADS)
      x[i] = (expf(x[i] - m) / s - (i == tgt ? 1.f : 0.f)) * mk;
  }
}

}  // namespace

// CE-row. logits [rows, V] f32 (contiguous; overwritten by dlog when
// with_grads), targets [rows] int32 in [0, V), mask [rows] f32 (0 or 1),
// nll [rows] f32. One launch on `stream`.
extern "C" int svt_ce_rows(void* logits, const void* targets, const void* mask, void* nll,
                           int rows, long long V, int with_grads, void* stream) {
  if (rows <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  ce_rows_kernel<<<rows, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (float*)logits, (const int*)targets, (const float*)mask, (float*)nll, V, with_grads);
  return (int)cudaGetLastError();
}
