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
// in the JAX order, and the int32 sums are exact (in any order), so the
// kernel is bitwise equal to its plain version (ops/quant.py `qdot_plain`,
// `int8_gemm_plain`).
//
// Operand rows may be longer than K (a weight with K % 16 != 0 is stored
// with rows padded to a multiple of 16 bytes: QLinear); each path takes the
// row strides in bytes.
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
//     `wgmma.mma_async m64nNk32.s32.s8.s8` (N = BN = 256, or 128 where that
//     pads N less) with both operands K-major in shared memory, fed by TMA
//     (2-d tensor maps, 128-byte swizzle: one box row is 128 int8 of K) into
//     a ring of 4 (BN 256) or 6 (BN 128) stages of 128-byte K blocks; one
//     producer thread starts the copies, two consumer warpgroups (64 rows of
//     the 128-row tile each, `setmaxnreg` 232) run the products and keep
//     one product group in flight. Rows past M, channels past N and K past
//     its end lie outside the tensor maps and arrive as zeros; the epilogue
//     masks its stores.
//   * a grid sized to the card: one persistent CTA per SM over a host-made
//     plan (ops/quant.py `gemm_plan`): whole output tiles in full waves,
//     then the remaining tiles' (tile, K block) units cut into equal
//     contiguous shares (stream-K). A share that covers part of a tile's K
//     loop leaves its int32 partial in scratch; the last share of the tile
//     to arrive (an atomic counter) adds them up, exactly, and runs the
//     epilogue once. So the serving shapes (20-160 tiles of 128 x 256) and
//     the 4096^3 probe all fill the 132 SMs.
//   * weights are static: a tensor map is encoded once per (pointer, shape,
//     stride) and cached, not once per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using namespace hopper;

constexpr int SMALL_M = 4;  // rows handled by the decode path
constexpr int GV_WARPS = 8;
constexpr int GV_THREADS = GV_WARPS * 32;
constexpr int GV_UNROLL = 4;
constexpr int GV_CTAS_PER_SM = 4;

constexpr int BM = 128;         // rows of an output tile
constexpr int BK = 128;         // bytes of K per ring stage (one swizzled box row)
constexpr int CONSUMERS = 2;    // warpgroups of WG_ROWS rows each
constexpr int WG_ROWS = BM / CONSUMERS;
constexpr int TILE_THREADS = (CONSUMERS + 1) * 128;  // + one producer warpgroup
constexpr int SEG_INTS = 6;     // m tile, n tile, first K block, end K block, slot, fixup

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
// bf16 and is quantized here. Shared memory: M rows of Kpad int8. VEC16: w's
// rows are 16-byte aligned, read 16 bytes at a time (a row's last load may
// reach past K into its padding, which meets zeros of the quantized row).
template <typename XT, typename OutT, bool VEC16>
__global__ void __launch_bounds__(GV_THREADS) gemv_kernel(
    const XT* __restrict__ x, int ldx,      // [M, K], rows ldx elements apart
    const int8_t* __restrict__ w, int ldw,  // [N, K], rows ldw bytes apart
    const float* __restrict__ ws,     // [N] weight scales (null for int32)
    const OutT* __restrict__ bias,    // [N] or null
    OutT* __restrict__ out,           // [M, N]
    int M, int N, int K, int Kpad) {
  extern __shared__ __align__(16) int8_t sq[];
  __shared__ float ssx[SMALL_M];
  __shared__ float red[GV_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int m = 0; m < M; ++m) {
    const XT* xr = x + (size_t)m * ldx;
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
    const int8_t* wr = w + (size_t)n * ldw;
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

// one CTA per row: sx[m] and xq[m, :K], the row `ldq` bytes long with zeros
// in [K, ldq)
template <typename XT>
__global__ void __launch_bounds__(QR_THREADS) quantize_rows_kernel(
    const XT* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int K, int ldq) {
  __shared__ float red[QR_THREADS / 32];
  const XT* xr = x + (size_t)blockIdx.x * K;
  int8_t* qr = xq + (size_t)blockIdx.x * ldq;
  float a = 0.f;
  for (int k = threadIdx.x; k < K; k += QR_THREADS) a = fmaxf(a, fabsf(to_f(xr[k])));
  const float s = row_scale(block_max(a, red));
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  for (int k = threadIdx.x; k < ldq; k += QR_THREADS) {
    qr[k] = k < K ? quantize_value(to_f(xr[k]), s) : (int8_t)0;
  }
}

// two output values of one row, columns c and c + 1 (c even; cl = c - the
// tile's first column): one vector store when the row stride keeps the pair
// aligned, else two scalar ones. ws and bias hold the tile's weight scales
// and bias (shared memory; null for the int32 form and for no bias).
template <typename OutT>
__device__ __forceinline__ void store_two(OutT* row, int c, int cl, int N, bool pair, int a0,
                                          int a1, float rs, const float* ws, const OutT* bias) {
  if (pair && c + 1 < N) {
    OutT v[2];
    store_out(&v[0], a0, rs, ws ? ws[cl] : 0.f, bias ? bias + cl : nullptr);
    store_out(&v[1], a1, rs, ws ? ws[cl + 1] : 0.f, bias ? bias + cl + 1 : nullptr);
    if constexpr (sizeof(OutT) == 2) {
      *reinterpret_cast<uint32_t*>(row + c) = *reinterpret_cast<const uint32_t*>(v);
    } else {
      *reinterpret_cast<uint2*>(row + c) = *reinterpret_cast<const uint2*>(v);
    }
    return;
  }
  if (c < N) store_out(row + c, a0, rs, ws ? ws[cl] : 0.f, bias ? bias + cl : nullptr);
  if (c + 1 < N) {
    store_out(row + c + 1, a1, rs, ws ? ws[cl + 1] : 0.f, bias ? bias + cl + 1 : nullptr);
  }
}

template <int BN>
struct TileCfg {
  static constexpr int A_BYTES = BM * BK;                 // one A stage: 16 KB
  static constexpr int B_BYTES = BN * BK;                 // one B stage: 16 or 32 KB
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 256 ? 4 : 6;        // 192 KB of ring either way
  static constexpr int ACC = BN / 2;                      // int32 accumulators a thread
  static constexpr int PART_INTS = WG_ROWS * BN;          // one warpgroup's partial tile
  // + barriers, the last-arrival flags, and each consumer warpgroup's copy
  // of the tile's weight scales and bias (4 bytes each at most)
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8 + 16 + 2 * CONSUMERS * BN * 4;
};

template <int BN>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[BN / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BN == 256) {
    wgmma_m64n256k32_s8(d, da, db, scale_d);
  } else {
    wgmma_m64n128k32_s8(d, da, db, scale_d);
  }
}

// The tiled product over a host-made plan (ops/quant.py `gemm_plan`): CTA c
// runs segments segs[cta_segs[c] : cta_segs[c + 1]], each one output tile
// (m tile, n tile) over a range of 128-byte K blocks. A segment that covers
// all of its tile's K blocks applies the epilogue from registers; one that
// covers a share leaves its int32 partial in `part` and counts itself in;
// the last of a tile's segments to arrive sums the tile's partials
// (exactly: int32) and applies the epilogue once.
template <int BN, typename OutT>
__global__ void __launch_bounds__(TILE_THREADS, 1) gemm_tiled_kernel(
    const __grid_constant__ CUtensorMap a_map,  // xq [M, K] int8, boxes {128, BM}
    const __grid_constant__ CUtensorMap b_map,  // w [N, K] int8, boxes {128, BN}
    const float* __restrict__ sx,     // [M] row scales (null for int32)
    const float* __restrict__ ws,     // [N] weight scales (null for int32)
    const OutT* __restrict__ bias,    // [N] or null
    OutT* __restrict__ out,           // [M, N]
    int* __restrict__ part,           // [n_slots, 2, PART_INTS] int32 partials
    int* __restrict__ counters,       // [n_fixups, 2], zero between calls
    const int* __restrict__ segs,     // [n_segs, SEG_INTS]
    const int* __restrict__ cta_segs, // [n_ctas + 1]
    const int* __restrict__ fixups,   // [n_fixups, 2]: first slot, count
    int M, int N) {
  using C = TileCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  int* s_last = reinterpret_cast<int*>(empty + C::STAGES);
  float* s_ws = reinterpret_cast<float*>(s_last + 4);                   // [CONSUMERS][BN]
  OutT* s_bias = reinterpret_cast<OutT*>(s_ws + CONSUMERS * BN);         // [CONSUMERS][BN]

  const int wg = threadIdx.x / 128;
  const int seg_begin = cta_segs[blockIdx.x];
  const int seg_end = cta_segs[blockIdx.x + 1];

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full
    regs_dealloc<40>();
    if (threadIdx.x % 128 == 0) {
      tma_prefetch_map(&a_map);
      tma_prefetch_map(&b_map);
      int stage = 0;
      uint32_t phase = 0;
      for (int si = seg_begin; si < seg_end; ++si) {
        const int* sg = segs + si * SEG_INTS;
        const int m0 = sg[0] * BM, n0 = sg[1] * BN;
        for (int kb = sg[2]; kb < sg[3]; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * C::STAGE_BYTES;
          mbar_arrive_expect_tx(&full[stage], C::STAGE_BYTES);
          tma_load_2d(st, &a_map, &full[stage], kb * BK, m0);
          tma_load_2d(st + C::A_BYTES, &b_map, &full[stage], kb * BK, n0);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // stay until the consumers have released every stage in flight
      for (int s = 0; s < C::STAGES; ++s) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [wg * 64, wg * 64 + 64) of a tile
  regs_alloc<232>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const bool pair = N % 2 == 0;
  int stage = 0;
  uint32_t phase = 0;
  uint32_t acc[C::ACC];

  for (int si = seg_begin; si < seg_end; ++si) {
    const int* sg = segs + si * SEG_INTS;
    const int m0 = sg[0] * BM, n0 = sg[1] * BN, kb0 = sg[2], kb1 = sg[3];
    const int slot = sg[4], fix = sg[5];

    int prev = -1;
    for (int kb = kb0; kb < kb1; ++kb) {
      const unsigned char* st = smem + stage * C::STAGE_BYTES;
      mbar_wait(&full[stage], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint64_t da = smem_desc_sw128(st + wg * (WG_ROWS * BK) + kk * 32, 16, 1024);
        const uint64_t db = smem_desc_sw128(st + C::A_BYTES + kk * 32, 16, 1024);
        wgmma_s8<BN>(acc, da, db, kb > kb0 || kk > 0);
      }
      wgmma_commit();
      // one product group stays in flight: the one before it has finished
      // reading its stage, which goes back to the producer
      wgmma_wait<1>();
      fence_regs(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

    if (slot >= 0) {
      // a share of the tile's K blocks: leave the int32 partial, count in,
      // and let the last arrival reduce
      int* mine = part + ((size_t)slot * CONSUMERS + wg) * C::PART_INTS;
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) mine[i * 128 + tid] = (int)acc[i];
      __threadfence();
      named_barrier_sync(1 + wg, 128);
      const int* fx = fixups + fix * 2;
      if (tid == 0) {
        const int seen = atomicAdd(&counters[fix * CONSUMERS + wg], 1);
        s_last[wg] = seen == fx[1] - 1;
      }
      named_barrier_sync(1 + wg, 128);
      if (!s_last[wg]) continue;
      __threadfence();
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) acc[i] = 0u;
      for (int p = fx[0]; p < fx[0] + fx[1]; ++p) {
        const int* src = part + ((size_t)p * CONSUMERS + wg) * C::PART_INTS;
#pragma unroll
        for (int i = 0; i < C::ACC; ++i) acc[i] += (uint32_t)__ldcg(src + i * 128 + tid);
      }
      if (tid == 0) counters[fix * CONSUMERS + wg] = 0;  // ready for the next call
    }

    // the tile's weight scales and bias, read once per tile into shared
    // memory (per element from global memory, each load would wait behind
    // the stores before it: out may alias them as far as the compiler knows)
    float* tws = s_ws + wg * BN;
    OutT* tb = s_bias + wg * BN;
    if (ws) {
      named_barrier_sync(1 + wg, 128);  // the last tile's epilogue is done with them
      for (int i = tid; i < BN && n0 + i < N; i += 128) {
        tws[i] = ws[n0 + i];
        if (bias) tb[i] = bias[n0 + i];
      }
      named_barrier_sync(1 + wg, 128);
    }

    // epilogue: rows ra, ra + 8 of this thread; columns 8j + 2 (lane % 4) + {0, 1}
    const int ra = m0 + wg * WG_ROWS + warp * 16 + lane / 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ra + 8 * half;
      if (r >= M) continue;
      const float rs = sx ? sx[r] : 0.f;
      OutT* row = out + (size_t)r * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * (lane % 4);
        store_two(row, n0 + cl, cl, N, pair, (int)acc[4 * j + 2 * half],
                  (int)acc[4 * j + 2 * half + 1], rs, ws ? tws : nullptr, bias ? tb : nullptr);
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
void launch_gemv_vec(const void* x, int ldx, const void* w, int ldw, const void* ws,
                     const void* bias, void* out, int M, int N, int K, cudaStream_t s) {
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
      (const XT*)x, ldx, (const int8_t*)w, ldw, (const float*)ws, (const OutT*)bias, (OutT*)out,
      M, N, K, Kpad);
}

// 16-byte weight loads when the weight's rows are 16-byte aligned (a row
// padded past K reads its padding against zeros of the quantized row)
template <typename XT, typename OutT>
void launch_gemv(const void* x, int ldx, const void* w, int ldw, const void* ws, const void* bias,
                 void* out, int M, int N, int K, cudaStream_t s) {
  if (ldw % 16 == 0) {
    launch_gemv_vec<XT, OutT, true>(x, ldx, w, ldw, ws, bias, out, M, N, K, s);
  } else {
    launch_gemv_vec<XT, OutT, false>(x, ldx, w, ldw, ws, bias, out, M, N, K, s);
  }
}

// A tensor map is a pure function of (base, rows, cols, row stride, box
// rows), so maps are encoded once per such key and kept: a weight's map is
// encoded on its first product and reused by every later one.
struct MapKey {
  uintptr_t base;
  int rows, cols, box_rows;
  uint64_t stride;
  bool operator==(const MapKey& o) const {
    return base == o.base && rows == o.rows && cols == o.cols && box_rows == o.box_rows &&
           stride == o.stride;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<uintptr_t>()(k.base);
    h = h * 1000003u ^ (size_t)k.rows;
    h = h * 1000003u ^ (size_t)k.cols;
    h = h * 1000003u ^ (size_t)k.box_rows;
    return h * 1000003u ^ (size_t)k.stride;
  }
};

constexpr size_t MAP_CACHE_MAX = 4096;
std::mutex map_mutex;
std::unordered_map<MapKey, CUtensorMap, MapKeyHash> map_cache;
size_t map_encodes = 0;  // maps encoded so far (svt_int8_maps_encoded)

bool cached_map(CUtensorMap* map, const void* base, int rows, int cols, int stride, int box_rows) {
  const MapKey key{reinterpret_cast<uintptr_t>(base), rows, cols, box_rows, (uint64_t)stride};
  std::lock_guard<std::mutex> lock(map_mutex);
  auto it = map_cache.find(key);
  if (it != map_cache.end()) {
    *map = it->second;
    return true;
  }
  if (!svt_tensor_map_s8(map, base, rows, cols, (uint64_t)stride, box_rows)) return false;
  if (map_cache.size() >= MAP_CACHE_MAX) map_cache.clear();
  map_cache.emplace(key, *map);
  ++map_encodes;
  return true;
}

template <int BN, typename OutT>
cudaError_t launch_tiled_bn(const void* a, int lda, const void* b, int ldb, const void* sx,
                            const void* ws, const void* bias, void* out, int M, int N, int K,
                            const int* plan, int n_ctas, int n_segs, void* part, void* counters,
                            cudaStream_t s) {
  CUtensorMap a_map, b_map;
  if (!cached_map(&a_map, a, M, K, lda, BM) || !cached_map(&b_map, b, N, K, ldb, BN)) {
    return cudaErrorInvalidValue;
  }
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_tiled_kernel<BN, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TileCfg<BN>::SMEM);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  const int* cta_segs = plan + n_segs * SEG_INTS;
  const int* fixups = cta_segs + n_ctas + 1;
  gemm_tiled_kernel<BN, OutT><<<n_ctas, TILE_THREADS, TileCfg<BN>::SMEM, s>>>(
      a_map, b_map, (const float*)sx, (const float*)ws, (const OutT*)bias, (OutT*)out,
      (int*)part, (int*)counters, plan, cta_segs, fixups, M, N);
  return cudaSuccess;
}

template <typename OutT>
cudaError_t launch_tiled(const void* a, int lda, const void* b, int ldb, const void* sx,
                         const void* ws, const void* bias, void* out, int M, int N, int K,
                         const int* plan, int n_ctas, int n_segs, int bn, void* part,
                         void* counters, cudaStream_t s) {
  if (lda % 16 || ldb % 16 || !plan || n_ctas < 1 || !part || !counters) {
    return cudaErrorInvalidValue;
  }
  if (bn == 256) {
    return launch_tiled_bn<256, OutT>(a, lda, b, ldb, sx, ws, bias, out, M, N, K, plan, n_ctas,
                                      n_segs, part, counters, s);
  }
  if (bn == 128) {
    return launch_tiled_bn<128, OutT>(a, lda, b, ldb, sx, ws, bias, out, M, N, K, plan, n_ctas,
                                      n_segs, part, counters, s);
  }
  return cudaErrorInvalidValue;
}

template <typename XT, typename OutT>
cudaError_t launch_qdot(const void* x, const void* w, int ldw, const void* ws, const void* bias,
                        void* out, void* xq, int ldq, void* sx, int M, int N, int K,
                        const int* plan, int n_ctas, int n_segs, int bn, void* part,
                        void* counters, cudaStream_t s) {
  if (M <= SMALL_M) {
    launch_gemv<XT, OutT>(x, K, w, ldw, ws, bias, out, M, N, K, s);
    return cudaSuccess;
  }
  quantize_rows_kernel<XT><<<M, QR_THREADS, 0, s>>>((const XT*)x, (int8_t*)xq, (float*)sx, K, ldq);
  return launch_tiled<OutT>(xq, ldq, w, ldw, sx, ws, bias, out, M, N, K, plan, n_ctas, n_segs, bn,
                            part, counters, s);
}

bool bad_shape(int M, int N, int K, int ldw) {
  return M < 1 || N < 1 || K < 4 || K % 4 != 0 || ldw < K || ldw % 4 != 0;
}

}  // namespace

// rows at or below which the decode path runs (the wrapper makes a plan and
// the xq / sx scratch only above it)
extern "C" int svt_int8_small_m() { return SMALL_M; }

// K5's tile: rows and 128-byte K blocks (ops/quant.py GEMM_BM, GEMM_BK)
extern "C" int svt_int8_block_m() { return BM; }
extern "C" int svt_int8_block_k() { return BK; }

// how many tensor maps the library has encoded (a cached weight map is not
// encoded again)
extern "C" long long svt_int8_maps_encoded() {
  std::lock_guard<std::mutex> lock(map_mutex);
  return (long long)map_encodes;
}

// K5's own function: int32 [M, N] = int8 [M, K] . int8 [N, K]^T, rows lda
// and ldb bytes apart. Above SMALL_M rows: the tiled path over `plan`
// (int32 on the device: [n_segs * 6 segments][n_ctas + 1][n_fixups * 2]),
// with tile width bn, partial scratch `part` and zeroed `counters`; both
// strides must then be multiples of 16.
extern "C" int svt_int8_gemm(const void* a, int lda, const void* b, int ldb, void* out, int M,
                             int N, int K, const void* plan, int n_ctas, int n_segs, int bn,
                             void* part, void* counters, void* stream) {
  if (bad_shape(M, N, K, ldb) || lda < K || lda % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= SMALL_M) {
    launch_gemv<int8_t, int32_t>(a, lda, b, ldb, nullptr, nullptr, out, M, N, K, s);
  } else {
    const cudaError_t e = launch_tiled<int32_t>(a, lda, b, ldb, nullptr, nullptr, nullptr, out, M,
                                                N, K, (const int*)plan, n_ctas, n_segs, bn, part,
                                                counters, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// qdot: x [M, K] (bf16 if x_bf16 else f32) -> out [M, N] (bf16 if out_bf16
// else f32), + bias [N] in the output type when not null; the weight's rows
// are ldw bytes apart. For M > SMALL_M: xq [M, ldq] int8 and sx [M] f32 are
// scratch of the row-quantize pass, and plan / bn / part / counters are as
// svt_int8_gemm's (null otherwise).
extern "C" int svt_qdot(const void* x, int x_bf16, const void* w, int ldw, const void* ws,
                        const void* bias, void* out, int out_bf16, void* xq, int ldq, void* sx,
                        int M, int N, int K, const void* plan, int n_ctas, int n_segs, int bn,
                        void* part, void* counters, void* stream) {
  if (bad_shape(M, N, K, ldw) || (M > SMALL_M && (!xq || !sx || ldq < K))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* pl = (const int*)plan;
  cudaError_t e;
  if (x_bf16 && out_bf16) {
    e = launch_qdot<bf16, bf16>(x, w, ldw, ws, bias, out, xq, ldq, sx, M, N, K, pl, n_ctas,
                                n_segs, bn, part, counters, s);
  } else if (x_bf16) {
    e = launch_qdot<bf16, float>(x, w, ldw, ws, bias, out, xq, ldq, sx, M, N, K, pl, n_ctas,
                                 n_segs, bn, part, counters, s);
  } else if (out_bf16) {
    e = launch_qdot<float, bf16>(x, w, ldw, ws, bias, out, xq, ldq, sx, M, N, K, pl, n_ctas,
                                 n_segs, bn, part, counters, s);
  } else {
    e = launch_qdot<float, float>(x, w, ldw, ws, bias, out, xq, ldq, sx, M, N, K, pl, n_ctas,
                                  n_segs, bn, part, counters, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
