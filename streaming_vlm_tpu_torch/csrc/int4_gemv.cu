// W4A8 matrix product at up to 31 rows: kernel K5-int4 of the port.
//
// Replaces the int8 x packed-int4 branch of the JAX package's `qdot4`
// (streaming_vlm_tpu/ops/quant.py:126, T < 32), which XLA computes there:
// no Pallas kernel and no single PyTorch call computes it, and unpacking
// the nibbles into an int8 copy first would read more bytes than W8A8.
// x [M, K] (bf16 or f32) times a weight stored [N, K/2] int8, contract rows
// 2d and 2d+1 of output channel n in the low and high nibble of byte d,
// with f32 scales s [N, ng], one per 128-row group (ng = K / 128), or one
// for the whole row when 128 does not divide K (ng = 1).
//
// Arithmetic, each step one IEEE operation in the JAX order (so the kernel
// is bitwise equal to ops/quant.py `qdot4_plain`):
//   sx = max(max|x_m| * f32(1/127), 1e-12); xq = clip(rint(x / sx), -127, 127)
//   acc_g = sum over group g of xq * w (int32, exact in any order)
//   ng > 1: fold = 0; fold = fma(f32(acc_g), s_g, fold) for g = 0, 1, ...;
//           out = fold * sx (jit contracts jnp.sum(acc * s, axis=0) into
//           that chain of fused multiply-adds)
//   ng = 1: out = acc * (sx * s)
// then, for a bf16 output, the round to bf16 and + bias in bf16; for an f32
// output the last product and + bias are one fused multiply-add (as jit
// fuses them).
//
// What bounds it on an H100, and what the design does about it: bytes. The
// packed weight (half a byte a weight, 36 MB for the 7B gate/up product) is
// read once at 3.35 TB/s, against ~4 ops a weight byte. Each CTA quantizes
// its rows into shared memory in its prologue (no second launch), even and
// odd contract rows apart, so that a packed word's low nibbles meet four
// even rows and its high nibbles four odd rows in one `__dp4a` each; each
// row's groups are 144 bytes apart (64 even + 64 odd + 16 of padding), so
// the 16-byte reads of 32 lanes on 32 consecutive groups hit distinct
// banks. A warp takes one output channel at a time; lane l streams group
// 32 r + l of its packed row (4 loads of 16 bytes in flight), sign-extends
// the nibbles in registers and sums that group's int32 product per row. The
// fold across groups must run in group order, so the lanes leave their
// sums (as f32, exact) and scales in shared memory and lane m folds row m.
// No output's K is split across CTAs, so the fold order is fixed. Rows past what
// shared memory holds at once (PASS_ROWS, or fewer at a long K) run in
// further passes over the weight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int GROUP = 128;           // contract rows per scale group (ops/quant.py INT4_GROUP)
constexpr int GROUP_BYTES = GROUP / 2;  // packed bytes of one group
constexpr int XSTRIDE = 144;         // shared bytes per (row, group): even, odd, padding
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CTAS_PER_SM = 4;
constexpr int MAX_ROWS = 31;         // ops/quant.py INT4_MAX_ROWS
constexpr int PASS_ROWS = 8;         // rows one pass accumulates
constexpr int SMEM_CAP = 96 * 1024;  // shared bytes of quantized rows a CTA may take

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

constexpr float INV127 = 0x1.020408p-7f;  // 1.f / 127.f, correctly rounded

// qdot4's row scale: max|x| / 127 as jit computes it, clamped at 1e-12
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fmul_rn(amax, INV127), 1e-12f);
}

// clip(round_half_even(x / sx), -127, 127)
__device__ __forceinline__ int8_t quantize_value(float x, float sx) {
  const float r = rintf(__fdiv_rn(x, sx));
  return (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

// max over the block (every thread gets it); red holds one float per warp
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < WARPS; ++w) v = fmaxf(v, red[w]);
  __syncthreads();
  return v;
}

// (int8_t)(b << 4) >> 4 for each byte b of v: the low nibbles, sign-extended
// ((n ^ 8) - 8 per byte, without borrows between bytes)
__device__ __forceinline__ int lo_nibbles(unsigned v) {
  return (int)__vsub4((v & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// (int8_t)b >> 4 for each byte b of v: the high nibbles, sign-extended
__device__ __forceinline__ int hi_nibbles(unsigned v) {
  return (int)__vsub4(((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// four packed bytes against four even and four odd quantized rows
__device__ __forceinline__ int dot_word(unsigned w, int xe, int xo, int acc) {
  return __dp4a(hi_nibbles(w), xo, __dp4a(lo_nibbles(w), xe, acc));
}

// the epilogue of out = a * b (+ bias): f32 out fuses the bias into one
// fused multiply-add (as jit fuses the f32 `* sx + b`); bf16 out rounds a * b
// to bf16, then adds the bias in bf16
__device__ __forceinline__ void store_out(float* p, float a, float b, const float* bias) {
  *p = bias ? __fmaf_rn(a, b, *bias) : __fmul_rn(a, b);
}
__device__ __forceinline__ void store_out(bf16* p, float a, float b, const bf16* bias) {
  bf16 y = __float2bfloat16_rn(__fmul_rn(a, b));
  if (bias) y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), __bfloat162float(*bias)));
  *p = y;
}

// MR: rows a pass holds in registers (1, or PASS_ROWS); VEC16: the packed
// rows (K / 2 bytes) are a multiple of 16 bytes, read 16 bytes at a time
// (else 4 at a time). Shared memory: `rows_per_pass` rows of `ngroups`
// (ceil(K / 128)) groups of XSTRIDE bytes.
template <typename XT, typename OutT, int MR, bool VEC16>
__global__ void __launch_bounds__(THREADS) int4_gemv_kernel(
    const XT* __restrict__ x,         // [M, K]
    const uint8_t* __restrict__ w,    // [N, K / 2] packed
    const float* __restrict__ ws,     // [N, ng]
    const OutT* __restrict__ bias,    // [N] or null
    OutT* __restrict__ out,           // [M, N]
    int M, int N, int K, int ng, int rows_per_pass) {
  extern __shared__ __align__(16) int8_t sq[];
  __shared__ float ssx[MR];
  __shared__ float red[WARPS];
  __shared__ float sacc[WARPS][32][MR];  // a round's group sums, per warp
  __shared__ float sscale[WARPS][32];     // and their scales
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ngroups = (K + GROUP - 1) / GROUP;
  const int row_bytes = ngroups * XSTRIDE;
  const int kb = K / 2;  // packed bytes a row

  for (int m0 = 0; m0 < M; m0 += rows_per_pass) {
    const int rows = min(rows_per_pass, M - m0);
    __syncthreads();  // the previous pass is done with the rows
    for (int r = 0; r < rows; ++r) {
      const XT* xr = x + (size_t)(m0 + r) * K;
      float a = 0.f;
      for (int k = tid; k < K; k += THREADS) a = fmaxf(a, fabsf(to_f(xr[k])));
      const float sx = row_scale(block_max(a, red));
      if (tid == 0) ssx[r] = sx;
      int8_t* qr = sq + r * row_bytes;
      for (int k = tid; k < ngroups * GROUP; k += THREADS) {
        const int g = k / GROUP, j = k % GROUP;
        qr[g * XSTRIDE + (j & 1) * GROUP_BYTES + (j >> 1)] =
            k < K ? quantize_value(to_f(xr[k]), sx) : (int8_t)0;
      }
    }
    __syncthreads();

    for (int n = blockIdx.x * WARPS + warp; n < N; n += gridDim.x * WARPS) {
      const uint8_t* wr = w + (size_t)n * kb;
      int total[MR];  // ng == 1: the row's int32 sum
      float fold = 0.f;  // ng > 1: lane m's running fold of row m
#pragma unroll
      for (int r = 0; r < MR; ++r) total[r] = 0;
      for (int g0 = 0; g0 < ngroups; g0 += 32) {
        const int g = g0 + lane;
        int acc[MR];
#pragma unroll
        for (int r = 0; r < MR; ++r) acc[r] = 0;
        if (g < ngroups) {
          const int8_t* xg = sq + g * XSTRIDE;
          const int off = g * GROUP_BYTES;
          if constexpr (VEC16) {
            uint4 wv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              wv[u] = off + 16 * u < kb ? __ldg(reinterpret_cast<const uint4*>(wr + off + 16 * u))
                                        : make_uint4(0, 0, 0, 0);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
              for (int r = 0; r < MR; ++r) {
                if (r < rows) {
                  const int8_t* xrow = xg + r * row_bytes + 16 * u;
                  const uint4 xe = *reinterpret_cast<const uint4*>(xrow);
                  const uint4 xo = *reinterpret_cast<const uint4*>(xrow + GROUP_BYTES);
                  int s = acc[r];
                  s = dot_word(wv[u].x, (int)xe.x, (int)xo.x, s);
                  s = dot_word(wv[u].y, (int)xe.y, (int)xo.y, s);
                  s = dot_word(wv[u].z, (int)xe.z, (int)xo.z, s);
                  acc[r] = dot_word(wv[u].w, (int)xe.w, (int)xo.w, s);
                }
              }
            }
          } else {
            unsigned wv[16];
#pragma unroll
            for (int u = 0; u < 16; ++u) {
              wv[u] = off + 4 * u < kb ? __ldg(reinterpret_cast<const unsigned*>(wr + off + 4 * u))
                                       : 0u;
            }
#pragma unroll
            for (int u = 0; u < 16; ++u) {
#pragma unroll
              for (int r = 0; r < MR; ++r) {
                if (r < rows) {
                  const int8_t* xrow = xg + r * row_bytes + 4 * u;
                  acc[r] = dot_word(wv[u], *reinterpret_cast<const int*>(xrow),
                                    *reinterpret_cast<const int*>(xrow + GROUP_BYTES), acc[r]);
                }
              }
            }
          }
        }
        if (ng == 1) {
#pragma unroll
          for (int r = 0; r < MR; ++r) total[r] += acc[r];
        } else {
          if (g < ngroups) {
            sscale[warp][lane] = ws[(size_t)n * ng + g];
#pragma unroll
            for (int r = 0; r < MR; ++r) sacc[warp][lane][r] = __int2float_rn(acc[r]);
          }
          __syncwarp();
          if (lane < rows) {  // lane m folds row m over this round's groups, in order
            const int last = min(32, ngroups - g0);
            for (int i = 0; i < last; ++i) {
              fold = __fmaf_rn(sacc[warp][i][lane], sscale[warp][i], fold);
            }
          }
          __syncwarp();
        }
      }
      if (ng == 1) {
        const float s = ws[n];
#pragma unroll
        for (int r = 0; r < MR; ++r) {
#pragma unroll
          for (int o = 16; o; o >>= 1) total[r] += __shfl_xor_sync(0xffffffffu, total[r], o);
          if (lane == r && r < rows) {
            store_out(out + (size_t)(m0 + r) * N + n, __int2float_rn(total[r]),
                      __fmul_rn(ssx[r], s), bias ? bias + n : nullptr);
          }
        }
      } else if (lane < rows) {
        store_out(out + (size_t)(m0 + lane) * N + n, fold, ssx[lane], bias ? bias + n : nullptr);
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename XT, typename OutT, int MR, bool VEC16>
cudaError_t launch_mr(const void* x, const void* w, const void* ws, const void* bias, void* out,
                      int M, int N, int K, int ng, cudaStream_t s) {
  const int row_bytes = (K + GROUP - 1) / GROUP * XSTRIDE;
  int rows = SMEM_CAP / row_bytes;
  if (rows < 1) return cudaErrorInvalidValue;
  if (rows > MR) rows = MR;
  if (rows > M) rows = M;
  const int smem = rows * row_bytes;
  static int opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(int4_gemv_kernel<XT, OutT, MR, VEC16>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  const int want = (N + WARPS - 1) / WARPS;
  const int cap = sm_count() * CTAS_PER_SM;
  const int grid = want < cap ? want : cap;
  int4_gemv_kernel<XT, OutT, MR, VEC16><<<grid, THREADS, smem, s>>>(
      (const XT*)x, (const uint8_t*)w, (const float*)ws, (const OutT*)bias, (OutT*)out, M, N, K,
      ng, rows);
  return cudaSuccess;
}

template <typename XT, typename OutT>
cudaError_t launch(const void* x, const void* w, const void* ws, const void* bias, void* out,
                   int M, int N, int K, int ng, cudaStream_t s) {
  const bool vec16 = (K / 2) % 16 == 0;
  if (M == 1) {
    return vec16 ? launch_mr<XT, OutT, 1, true>(x, w, ws, bias, out, M, N, K, ng, s)
                 : launch_mr<XT, OutT, 1, false>(x, w, ws, bias, out, M, N, K, ng, s);
  }
  return vec16 ? launch_mr<XT, OutT, PASS_ROWS, true>(x, w, ws, bias, out, M, N, K, ng, s)
               : launch_mr<XT, OutT, PASS_ROWS, false>(x, w, ws, bias, out, M, N, K, ng, s);
}

}  // namespace

// the most rows K5-int4 takes (qdot4 dequantizes above it)
extern "C" int svt_int4_max_rows() { return MAX_ROWS; }

// qdot4 at M <= MAX_ROWS: x [M, K] (bf16 if x_bf16 else f32), packed weight
// [N, K / 2] int8, scales [N, ng] f32 (ng = K / 128 when 128 divides K, else
// 1) -> out [M, N] (bf16 if out_bf16 else f32), + bias [N] in the output
// type when not null. K must be a multiple of 8 (whole 4-byte words of a
// packed row); every pointer 16-byte aligned.
extern "C" int svt_qdot4(const void* x, int x_bf16, const void* w, const void* ws,
                         const void* bias, void* out, int out_bf16, int M, int N, int K, int ng,
                         void* stream) {
  if (M < 1 || M > MAX_ROWS || N < 1 || K < 8 || K % 8 != 0 ||
      ng != (K % GROUP == 0 ? K / GROUP : 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_bf16 && out_bf16) {
    e = launch<bf16, bf16>(x, w, ws, bias, out, M, N, K, ng, s);
  } else if (x_bf16) {
    e = launch<bf16, float>(x, w, ws, bias, out, M, N, K, ng, s);
  } else if (out_bf16) {
    e = launch<float, bf16>(x, w, ws, bias, out, M, N, K, ng, s);
  } else {
    e = launch<float, float>(x, w, ws, bias, out, M, N, K, ng, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
