// W8A8 matrix product: kernel K5 of the port.
//
// Replaces the TPU kernel tools/profile_s8_mxu.py `pallas_mm` (:77, its
// pallas_call at :78) / `mm_kernel` (:71): s8 [M, K] x s8 [K, N] -> s32
// [M, N]. The weight is stored [N, K] (the port's nn.Linear layout, one
// output channel per row), so C = A . B^T. On the serving path it runs the
// JAX package's `qdot` (streaming_vlm_tpu/ops/quant.py:243): each row of x
// is quantized to int8 with sx = max|x| * f32(1/127) (clamped at 1e-12; XLA
// turns the source's / 127 into that product under jit),
// xq = clip(round_half_even(x / sx), -127, 127); the int32 product is
// rescaled as f32(acc) * (sx * s[n]), rounded to the output type, and the
// bias (if any) is added after that round, as `mm(x, w) + b` does.
//
// Every float step is one IEEE operation (__fdiv_rn, __fmul_rn, __fadd_rn,
// __int2float_rn, rintf; nvcc's default -prec-div=true and no fast math),
// in the JAX order, and the int32 sums are exact, so the kernel is bitwise
// equal to its plain version (ops/quant.py `qdot_plain`, `int8_gemm_plain`).
//
// What bounds it on an H100, and what the design does about it:
//   * decode (M = 1; at most SMALL_M rows) is bound by bytes: the int8
//     weight is read once (7.07 GB per 7B token) at 3.35 TB/s, against
//     ~2 ops per weight byte. gemv_kernel: the CTA quantizes its row(s)
//     into shared memory in its prologue (no second launch), then each warp
//     streams whole weight rows with 16-byte loads along K (4 in flight per
//     lane), `__dp4a` against the quantized row, and one warp reduction
//     per output channel. The grid is capped at 4 CTAs per SM, so each CTA
//     quantizes its row once for many channels.
//   * prefill (M = 640) and the vision tower (M = 2040, 510) are bound by
//     operations (1979 int8 TOPS dense): quantize_rows_kernel (one launch,
//     one CTA per row) writes xq and sx, then gemm_tiled_kernel runs
//     mma.sync m16n8k32 s8 x s8 -> s32 on 128 x 128 output tiles, 8 warps of
//     64 x 32, over a 3-stage cp.async ring of 64-byte-deep K tiles read
//     with ldmatrix from rows padded to 80 bytes (no bank conflicts).
//     wgmma and TMA are left for a later kernel.
//   * Ragged edges: rows past M, channels past N and K past its end are
//     zero-filled in shared memory (cp.async src-size 0) or masked. K need
//     only be a multiple of 4 (vision down_proj K = 3420): when K % 16 != 0
//     the loads are 4 bytes wide instead of 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SMALL_M = 4;  // rows handled by the decode path
constexpr int GV_WARPS = 8;
constexpr int GV_THREADS = GV_WARPS * 32;
constexpr int GV_UNROLL = 4;
constexpr int GV_CTAS_PER_SM = 4;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int LDS = BK + 16;  // padded shared-memory row (bytes)
constexpr int TILE_THREADS = 256;
constexpr int TILE_SMEM = STAGES * (BM + BN) * LDS;

constexpr int QR_THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// qdot's row scale: max|x| / 127, clamped at 1e-12. Under jit, XLA folds
// the division by the constant into a product with its f32 reciprocal, and
// the JAX package serves W8A8 under jit, so this multiplies too.
constexpr float INV127 = 0x1.020408p-7f;  // 1.f / 127.f, correctly rounded

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fmul_rn(amax, INV127), 1e-12f);
}

// qdot's activation quantization: clip(round_half_even(x / sx), -127, 127)
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
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = fmaxf(v, red[w]);
  __syncthreads();
  return v;
}

// the epilogue: int32 as it is, or f32(acc) * (sx * s) rounded to the
// output type, then + bias in the output type
__device__ __forceinline__ void store_out(int32_t* p, int acc, float, float, const int32_t*) {
  *p = acc;
}
__device__ __forceinline__ void store_out(float* p, int acc, float sx, float s, const float* b) {
  float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(sx, s));
  if (b) v = __fadd_rn(v, *b);
  *p = v;
}
__device__ __forceinline__ void store_out(bf16* p, int acc, float sx, float s, const bf16* b) {
  bf16 y = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(sx, s)));
  if (b) y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), __bfloat162float(*b)));
  *p = y;
}

// ---------------------------------------------------------------------------
// decode: M <= SMALL_M rows
// ---------------------------------------------------------------------------

// XT = int8_t: x is already quantized (the int32 form); else x is float or
// bf16 and is quantized here. Shared memory: M rows of Kpad int8.
template <typename XT, typename OutT, bool VEC16>
__global__ void __launch_bounds__(GV_THREADS) gemv_kernel(
    const XT* __restrict__ x,         // [M, K]
    const int8_t* __restrict__ w,     // [N, K]
    const float* __restrict__ ws,     // [N] weight scales (null for int32)
    const OutT* __restrict__ bias,    // [N] or null
    OutT* __restrict__ out,           // [M, N]
    int M, int N, int K, int Kpad) {
  extern __shared__ __align__(16) int8_t sq[];
  __shared__ float ssx[SMALL_M];
  __shared__ float red[GV_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int m = 0; m < M; ++m) {
    const XT* xr = x + (size_t)m * K;
    int8_t* qr = sq + m * Kpad;
    if constexpr (sizeof(XT) == 1) {
      for (int k = tid; k < Kpad; k += GV_THREADS) qr[k] = k < K ? (int8_t)xr[k] : 0;
    } else {
      float a = 0.f;
      for (int k = tid; k < K; k += GV_THREADS) a = fmaxf(a, fabsf(to_f(xr[k])));
      const float sx = row_scale(block_max(a, red));
      if (tid == 0) ssx[m] = sx;
      for (int k = tid; k < Kpad; k += GV_THREADS) {
        qr[k] = k < K ? quantize_value(to_f(xr[k]), sx) : (int8_t)0;
      }
    }
  }
  __syncthreads();

  for (int n = blockIdx.x * GV_WARPS + warp; n < N; n += gridDim.x * GV_WARPS) {
    const int8_t* wr = w + (size_t)n * K;
    int acc[SMALL_M];
#pragma unroll
    for (int m = 0; m < SMALL_M; ++m) acc[m] = 0;
    if constexpr (VEC16) {
      constexpr int STEP = 32 * 16;
      for (int k0 = lane * 16; k0 < K; k0 += STEP * GV_UNROLL) {
        uint4 wv[GV_UNROLL];
#pragma unroll
        for (int u = 0; u < GV_UNROLL; ++u) {
          const int k = k0 + u * STEP;
          wv[u] = k < K ? __ldg(reinterpret_cast<const uint4*>(wr + k)) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < GV_UNROLL; ++u) {
          const int k = k0 + u * STEP;
          if (k < K) {
#pragma unroll
            for (int m = 0; m < SMALL_M; ++m) {
              if (m < M) {
                const uint4 xv = *reinterpret_cast<const uint4*>(sq + m * Kpad + k);
                acc[m] = __dp4a((int)wv[u].x, (int)xv.x, acc[m]);
                acc[m] = __dp4a((int)wv[u].y, (int)xv.y, acc[m]);
                acc[m] = __dp4a((int)wv[u].z, (int)xv.z, acc[m]);
                acc[m] = __dp4a((int)wv[u].w, (int)xv.w, acc[m]);
              }
            }
          }
        }
      }
    } else {
      constexpr int STEP = 32 * 4;
      for (int k0 = lane * 4; k0 < K; k0 += STEP * GV_UNROLL) {
        int wv[GV_UNROLL];
#pragma unroll
        for (int u = 0; u < GV_UNROLL; ++u) {
          const int k = k0 + u * STEP;
          wv[u] = k < K ? __ldg(reinterpret_cast<const int*>(wr + k)) : 0;
        }
#pragma unroll
        for (int u = 0; u < GV_UNROLL; ++u) {
          const int k = k0 + u * STEP;
          if (k < K) {
#pragma unroll
            for (int m = 0; m < SMALL_M; ++m) {
              if (m < M) {
                acc[m] = __dp4a(wv[u], *reinterpret_cast<const int*>(sq + m * Kpad + k), acc[m]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < SMALL_M; ++m) {
#pragma unroll
      for (int o = 16; o; o >>= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < SMALL_M; ++m) {
        if (m < M) {
          store_out(out + (size_t)m * N + n, acc[m], ws ? ssx[m] : 0.f, ws ? ws[n] : 0.f,
                    bias ? bias + n : nullptr);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// prefill / vision: M > SMALL_M rows
// ---------------------------------------------------------------------------

// one CTA per row: sx[m] and xq[m, :]
template <typename XT>
__global__ void __launch_bounds__(QR_THREADS) quantize_rows_kernel(
    const XT* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int K) {
  __shared__ float red[QR_THREADS / 32];
  const size_t row = (size_t)blockIdx.x * K;
  float a = 0.f;
  for (int k = threadIdx.x; k < K; k += QR_THREADS) a = fmaxf(a, fabsf(to_f(x[row + k])));
  const float s = row_scale(block_max(a, red));
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  for (int k = threadIdx.x; k < K; k += QR_THREADS) xq[row + k] = quantize_value(to_f(x[row + k]), s);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a 128-row x 64-byte tile of a row-major [rows, K] int8 matrix into shared
// memory (row stride LDS), zero-filled past `rows` and past K
template <bool VEC16>
__device__ __forceinline__ void load_tile(uint32_t dst, const int8_t* __restrict__ g, int rows,
                                          int row0, int K, int k0) {
  if constexpr (VEC16) {
#pragma unroll
    for (int i = 0; i < BM * BK / 16 / TILE_THREADS; ++i) {
      const int c = threadIdx.x + i * TILE_THREADS;
      const int r = c >> 2, col = (c & 3) * 16;
      const bool ok = row0 + r < rows && k0 + col < K;
      cp_async16(dst + r * LDS + col, ok ? g + (size_t)(row0 + r) * K + k0 + col : g, ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / TILE_THREADS; ++i) {
      const int c = threadIdx.x + i * TILE_THREADS;
      const int r = c >> 4, col = (c & 15) * 4;
      const bool ok = row0 + r < rows && k0 + col < K;
      cp_async4(dst + r * LDS + col, ok ? g + (size_t)(row0 + r) * K + k0 + col : g, ok);
    }
  }
}

template <typename OutT, bool VEC16>
__global__ void __launch_bounds__(TILE_THREADS) gemm_tiled_kernel(
    const int8_t* __restrict__ a,     // [M, K]
    const int8_t* __restrict__ b,     // [N, K]
    const float* __restrict__ sx,     // [M] row scales (null for int32)
    const float* __restrict__ ws,     // [N] weight scales (null for int32)
    const OutT* __restrict__ bias,    // [N] or null
    OutT* __restrict__ out,           // [M, N]
    int M, int N, int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const uint32_t sa = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sb = sa + STAGES * BM * LDS;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) {
      load_tile<VEC16>(sa + s * BM * LDS, a, M, m0, K, s * BK);
      load_tile<VEC16>(sb + s * BN * LDS, b, N, n0, K, s * BK);
    }
    cp_async_commit();
  }

  // ldmatrix row addresses within a stage (A: 16-row m tiles; B: pairs of
  // 8-row n tiles)
  const uint32_t a_off = (wm * 64 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 16;
  const uint32_t b_off = (wn * 32 + (lane & 7) + (lane >> 4) * 8) * LDS + ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      const int st = nk % STAGES;
      load_tile<VEC16>(sa + st * BM * LDS, a, M, m0, K, nk * BK);
      load_tile<VEC16>(sb + st * BN * LDS, b, N, n0, K, nk * BK);
    }
    cp_async_commit();

    const int st = kt % STAGES;
    const uint32_t as = sa + st * BM * LDS + a_off;
    const uint32_t bs = sb + st * BN * LDS + b_off;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(af[i], as + i * 16 * LDS + kk);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + j * 16 * LDS + kk);
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + wm * 64 + i * 16 + (lane >> 2) + (e >> 1) * 8;
      if (r >= M) continue;
      const float rs = sx ? sx[r] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn * 32 + j * 8 + (lane & 3) * 2 + (e & 1);
        if (c < N) {
          store_out(out + (size_t)r * N + c, acc[i][j][e], rs, ws ? ws[c] : 0.f,
                    bias ? bias + c : nullptr);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (!count[dev]) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <typename XT, typename OutT, bool VEC16>
void launch_gemv_vec(const void* x, const void* w, const void* ws, const void* bias, void* out,
                     int M, int N, int K, cudaStream_t s) {
  const int Kpad = (K + 15) / 16 * 16;
  const int smem = M * Kpad;
  static int opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted) {
    cudaFuncSetAttribute(gemv_kernel<XT, OutT, VEC16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    opted = smem;
  }
  const int want = (N + GV_WARPS - 1) / GV_WARPS;
  const int grid = want < sm_count() * GV_CTAS_PER_SM ? want : sm_count() * GV_CTAS_PER_SM;
  gemv_kernel<XT, OutT, VEC16><<<grid, GV_THREADS, smem, s>>>(
      (const XT*)x, (const int8_t*)w, (const float*)ws, (const OutT*)bias, (OutT*)out, M, N, K,
      Kpad);
}

template <typename XT, typename OutT>
void launch_gemv(const void* x, const void* w, const void* ws, const void* bias, void* out, int M,
                 int N, int K, cudaStream_t s) {
  if (K % 16 == 0) {
    launch_gemv_vec<XT, OutT, true>(x, w, ws, bias, out, M, N, K, s);
  } else {
    launch_gemv_vec<XT, OutT, false>(x, w, ws, bias, out, M, N, K, s);
  }
}

template <typename OutT, bool VEC16>
void launch_tiled_vec(const void* a, const void* b, const void* sx, const void* ws,
                      const void* bias, void* out, int M, int N, int K, cudaStream_t s) {
  static bool opted = false;
  if (!opted) {
    cudaFuncSetAttribute(gemm_tiled_kernel<OutT, VEC16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_SMEM);
    opted = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_tiled_kernel<OutT, VEC16><<<grid, TILE_THREADS, TILE_SMEM, s>>>(
      (const int8_t*)a, (const int8_t*)b, (const float*)sx, (const float*)ws, (const OutT*)bias,
      (OutT*)out, M, N, K);
}

template <typename OutT>
void launch_tiled(const void* a, const void* b, const void* sx, const void* ws, const void* bias,
                  void* out, int M, int N, int K, cudaStream_t s) {
  if (K % 16 == 0) {
    launch_tiled_vec<OutT, true>(a, b, sx, ws, bias, out, M, N, K, s);
  } else {
    launch_tiled_vec<OutT, false>(a, b, sx, ws, bias, out, M, N, K, s);
  }
}

template <typename XT, typename OutT>
void launch_qdot(const void* x, const void* w, const void* ws, const void* bias, void* out,
                 void* xq, void* sx, int M, int N, int K, cudaStream_t s) {
  if (M <= SMALL_M) {
    launch_gemv<XT, OutT>(x, w, ws, bias, out, M, N, K, s);
    return;
  }
  quantize_rows_kernel<XT><<<M, QR_THREADS, 0, s>>>((const XT*)x, (int8_t*)xq, (float*)sx, K);
  launch_tiled<OutT>(xq, w, sx, ws, bias, out, M, N, K, s);
}

bool bad_shape(int M, int N, int K) { return M < 1 || N < 1 || K < 4 || K % 4 != 0; }

}  // namespace

// rows at or below which the decode path runs (the wrapper allocates the
// xq / sx scratch of svt_qdot only above it)
extern "C" int svt_int8_small_m() { return SMALL_M; }

// K5's own function: int32 [M, N] = int8 [M, K] . int8 [N, K]^T
extern "C" int svt_int8_gemm(const void* a, const void* b, void* out, int M, int N, int K,
                             void* stream) {
  if (bad_shape(M, N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= SMALL_M) {
    launch_gemv<int8_t, int32_t>(a, b, nullptr, nullptr, out, M, N, K, s);
  } else {
    launch_tiled<int32_t>(a, b, nullptr, nullptr, nullptr, out, M, N, K, s);
  }
  return (int)cudaGetLastError();
}

// qdot: x [M, K] (bf16 if x_bf16 else f32) -> out [M, N] (bf16 if out_bf16
// else f32), + bias [N] in the output type when not null. xq [M, K] int8 and
// sx [M] f32 are scratch for M > SMALL_M (null otherwise).
extern "C" int svt_qdot(const void* x, int x_bf16, const void* w, const void* ws,
                        const void* bias, void* out, int out_bf16, void* xq, void* sx, int M,
                        int N, int K, void* stream) {
  if (bad_shape(M, N, K) || (M > SMALL_M && (!xq || !sx))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16) {
    launch_qdot<bf16, bf16>(x, w, ws, bias, out, xq, sx, M, N, K, s);
  } else if (x_bf16) {
    launch_qdot<bf16, float>(x, w, ws, bias, out, xq, sx, M, N, K, s);
  } else if (out_bf16) {
    launch_qdot<float, bf16>(x, w, ws, bias, out, xq, sx, M, N, K, s);
  } else {
    launch_qdot<float, float>(x, w, ws, bias, out, xq, sx, M, N, K, s);
  }
  return (int)cudaGetLastError();
}
