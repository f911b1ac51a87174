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
// What bounds it on an H100: bytes. The packed weight and its scales (36 MB
// for the 7B gate/up product, 289 MB for the lm_head) are read once at
// 3.35 TB/s, against 2 M operations a weight: even at 31 rows the int8
// tensor cores need a fraction of that time. What the design does about it:
//   * An asynchronous weight ring per warp. A warp owns tiles of 16 output
//     channels (one mma row tile) and streams each over its K range in
//     stages of 4 groups: lane 0 starts a stage with one TMA box of {256
//     bytes, 16 channels} (rows of 256 contiguous bytes: the TMA unit's cost
//     goes by box rows, so 64-byte rows or a bulk copy a channel left it the
//     bottleneck) and one box of the tile's scales, counted in bytes on the
//     stage's mbarrier, and refills a stage as soon as the warp has read
//     it. Eight warps a CTA, one CTA an SM, 4 stages a warp (17 KB in
//     flight); a CTA with fewer tiles than warps gives the idle warps'
//     stages to the busy ones. The first stages start before the rows are
//     quantized, so HBM is busy from the first cycle.
//   * The rows are quantized once per CTA, only over the CTA's K range,
//     into shared memory at one byte a value: for each group the row's 64
//     even values, then its 64 odd ones (the nibble order), rows 64 bytes
//     apart, with each group's sum of the quantized row. The maxima pass
//     keeps 16 loads in flight a thread; where all rows fit in one such
//     batch (M K <= 32k bf16 values) the thread quantizes from the same
//     registers, so the rows cost one round trip. x / sx is taken as x *
//     (1 / sx) wherever that provably rounds to the same integer, and
//     round-to-integer and int-to-f32 as exact adds of 1.5 * 2^23: the
//     conversion units run at a quarter of the adders' rate.
//   * Nibbles feed int8 tensor-core products shared by every row:
//     `mma.sync m16n8k32.s32.s8.s8` with the weight as the 16-row A operand
//     and up to 8 rows of x as the 8 columns of B (swap-AB), 1, 2 or 4 such
//     row tiles (NT). A lane's 16-byte read of a group's packed bytes is
//     four k-steps of A: one LOP3 turns a word's low nibbles into bytes w +
//     8 (0..15, signed value offset by 8), a shift and one more its high
//     nibbles; the contraction order inside a group is free (int32 sums are
//     exact), so the even and odd halves of x line up with them. The
//     accumulator starts at -8 * (the group's sum of x), which takes the
//     offset back out exactly. A stage's four groups run as straight-line
//     code, two independent product chains a group.
//   * A fresh accumulator per group; each lane folds the four (channel, row)
//     sums it holds into its own f32 fold in group order with __fmaf_rn, so
//     the fold runs in parallel across lanes and its order is the plain
//     version's.
//   * A host plan (ops/quant.py `int4_plan`) may split K into slabs across
//     CTAs (`slabs` > 1; needed where a CTA's quantized rows would not fit,
//     31 rows at K = 18944). Each part then writes its exact per-group sums
//     (f32: |acc| < 2^24) and scales to scratch; the last part of a tile to
//     arrive (an atomic counter, reset by that part) copies them into its
//     ring and folds every group in order. The order never changes, so every
//     plan is bitwise equal to the plain version.
//   * Weights are static: their tensor maps are encoded once per (pointer,
//     shape, stride) and cached.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int GROUP = 128;                   // contract rows per scale group (ops/quant.py INT4_GROUP)
constexpr int GROUP_BYTES = GROUP / 2;       // packed bytes of one group
constexpr int GS = 4;                        // groups a ring stage (INT4_STAGE_GROUPS)
constexpr int TILE_N = 16;                   // output channels a warp tile (INT4_TILE_N)
constexpr int WARPS = 8;                     // (INT4_WARPS)
constexpr int THREADS = WARPS * 32;
constexpr int W_ROW = GS * GROUP_BYTES;      // a channel's bytes of a stage: one TMA box row
constexpr int S_OFF = TILE_N * W_ROW;        // the stage's scales: [16][GS] f32
constexpr int STAGE = S_OFF + TILE_N * GS * 4;  // (INT4_STAGE_BYTES)
constexpr int MAX_STAGES = 16;               // stages a warp may hold (INT4_MAX_STAGES)
constexpr int MAX_ROWS = 31;                 // ops/quant.py INT4_MAX_ROWS
constexpr int SMEM_CAP = 232448;             // shared memory a block may take

__host__ __device__ constexpr int row_tiles(int M) { return M <= 8 ? 1 : M <= 16 ? 2 : 4; }

// The dynamic shared memory of a CTA for M rows, a slab of `gps` groups and
// `stages` stages a warp (ops/quant.py `int4_smem_bytes`): the warps' ring,
// the quantized rows, their group sums (x -8), the row scales, the row
// maxima, the warps' mbarriers, and slack to align the base.
struct Layout {
  int ring, x, corr, ssx, red, bars, total;
  __host__ __device__ Layout(int M, int gps, int stages) {
    const int mp = 8 * row_tiles(M);
    ring = 0;
    x = ring + WARPS * stages * STAGE;
    corr = x + M * GROUP * gps;
    ssx = corr + gps * mp * 4;
    red = ssx + mp * 4;
    bars = red + mp * 4;
    total = bars + WARPS * MAX_STAGES * 8 + 128;
  }
};

constexpr float INV127 = 0x1.020408p-7f;  // 1.f / 127.f, correctly rounded

// qdot4's row scale: max|x| / 127 as jit computes it, clamped at 1e-12
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fmul_rn(amax, INV127), 1e-12f);
}

// 1.5 * 2^23: for |v| < 2^22, the bits of v + MAGIC are 0x4B400000 + rint(v)
// (round half to even), and f32(i) = float_bits(0x4B400000 + i) - MAGIC
// exactly; both in full-rate adds, where F2I / FRND / I2F run at a quarter
constexpr float MAGIC = 12582912.f;
constexpr int MAGIC_BITS = 0x4B400000;

__device__ __forceinline__ int rint_int(float v) {
  return __float_as_int(__fadd_rn(v, MAGIC)) - MAGIC_BITS;
}

__device__ __forceinline__ float exact_f32(int i) {  // |i| < 2^22
  return __fsub_rn(__int_as_float(i + MAGIC_BITS), MAGIC);
}

// clip(round_half_even(x / sx), -127, 127), x / sx the correctly rounded
// quotient. y = x * rs (rs = 1 / sx rounded) is within 2 * 2^-24 |x / sx|
// <= 1.6e-5 of the exact quotient (|x / sx| <= 128), and that quotient
// rounded to f32 within 3.9e-6 more; so where no half-integer lies within
// 6.2e-5 of y (rint(y -+ 6.2e-5) agree), rint(y) is rint(x / sx). Only near
// a half-integer is the true division taken.
__device__ __forceinline__ int quantize_value(float x, float sx, float rs) {
  const float y = __fmul_rn(x, rs);
  int q = rint_int(y);
  if (rint_int(__fadd_rn(y, -6.2e-5f)) != rint_int(__fadd_rn(y, 6.2e-5f))) {
    q = rint_int(__fdiv_rn(x, sx));
  }
  return min(max(q, -127), 127);
}

// max |x| of the values in 16 bytes of a row (4 f32 or 8 bf16; bf16 |x|
// compared as 16-bit integers, two to a word, whose order is the values'
// for finite x)
template <typename XT>
__device__ __forceinline__ float absmax16(const uint4& a);
template <>
__device__ __forceinline__ float absmax16<float>(const uint4& a) {
  return fmaxf(fmaxf(fabsf(__uint_as_float(a.x)), fabsf(__uint_as_float(a.y))),
               fmaxf(fabsf(__uint_as_float(a.z)), fabsf(__uint_as_float(a.w))));
}
template <>
__device__ __forceinline__ float absmax16<bf16>(const uint4& a) {
  const unsigned m = __vmaxu2(__vmaxu2(a.x & 0x7FFF7FFFu, a.y & 0x7FFF7FFFu),
                              __vmaxu2(a.z & 0x7FFF7FFFu, a.w & 0x7FFF7FFFu));
  return __uint_as_float((m >> 16 > (m & 0xFFFFu) ? m >> 16 : m & 0xFFFFu) << 16);
}

// four consecutive values of a row as f32, from the 8 (bf16) or 16 (f32)
// bytes at p, loaded as raw words
template <typename XT>
__device__ __forceinline__ uint4 raw4(const XT* p);
template <>
__device__ __forceinline__ uint4 raw4<float>(const float* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
template <>
__device__ __forceinline__ uint4 raw4<bf16>(const bf16* p) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  return make_uint4(a.x, a.y, 0u, 0u);
}
template <typename XT>
__device__ __forceinline__ void values4(const uint4& a, float (&v)[4]);
template <>
__device__ __forceinline__ void values4<float>(const uint4& a, float (&v)[4]) {
  v[0] = __uint_as_float(a.x), v[1] = __uint_as_float(a.y);
  v[2] = __uint_as_float(a.z), v[3] = __uint_as_float(a.w);
}
template <>
__device__ __forceinline__ void values4<bf16>(const uint4& a, float (&v)[4]) {
  v[0] = __uint_as_float(a.x << 16), v[1] = __uint_as_float(a.x & 0xFFFF0000u);
  v[2] = __uint_as_float(a.y << 16), v[3] = __uint_as_float(a.y & 0xFFFF0000u);
}

// the low nibbles of the four bytes of v as bytes n + 8 (0..15): the signed
// nibble n offset by 8 (n ^ 8 per nibble)
__device__ __forceinline__ uint32_t lo_offset(uint32_t v) {
  return (v & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// the high nibbles, likewise
__device__ __forceinline__ uint32_t hi_offset(uint32_t v) {
  return ((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// D[16 x 8] += A[16 x 32] . B[32 x 8] in int32, s8 operands in registers,
// one warp (m16n8k32, A row-major, B column-major). Lane l, g = l / 4, t =
// l % 4: a0 = A[g][4t .. 4t+3], a1 = A[g+8][4t ..], a2 = A[g][16+4t ..],
// a3 = A[g+8][16+4t ..]; b0 = B[4t .. 4t+3][g], b1 = B[16+4t ..][g];
// d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// mbar_wait that traps after a second: a stage that never lands (a copy
// refused by the TMA unit) ends the launch with an error, not a hung card
__device__ __forceinline__ void wait_stage(uint64_t* bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 0xFFFFu) == 0xFFFFu) {  // rarely: reading the timer is slow
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (!t0) t0 = now;
      if (now - t0 > 1000000000ull) __trap();
    }
  }
}

// reductions into shared memory that return nothing (red.shared)
__device__ __forceinline__ void red_max(unsigned* p, unsigned v) {
  asm volatile("red.shared.max.u32 [%0], %1;\n" ::"r"(smem_u32(p)), "r"(v) : "memory");
}
__device__ __forceinline__ void red_add(int* p, int v) {
  asm volatile("red.shared.add.s32 [%0], %1;\n" ::"r"(smem_u32(p)), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
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

// CTA b runs slab b % slabs (groups [g0, g1) of the nk 128-row groups) for
// the tiles j + ctas * w + ctas * WARPS * i (j = b / slabs) in its warp w,
// i = 0, 1, ... (ops/quant.py `Int4Plan`). fold: ng > 1 (else one scale
// a row, read from ws). NT: row tiles of 8.
template <typename XT, typename OutT, int NT>
__global__ void __launch_bounds__(THREADS, 1) int4_gemv_kernel(
    const __grid_constant__ CUtensorMap wmap,  // packed weight [N, K / 2], boxes {256 B, 16}
    const __grid_constant__ CUtensorMap smap,  // scales [N, ng] f32, boxes {4, 16} (ng > 1)
    const XT* __restrict__ x,                  // [M, K]
    const float* __restrict__ ws,              // scales [N, ng], rows lds floats apart
    const OutT* __restrict__ bias,             // [N] or null
    OutT* __restrict__ out,                    // [M, N]
    float* __restrict__ scratch,               // slabs > 1: [T, nk, M + 1, 16] records
    int* __restrict__ counters,                // slabs > 1: [T], zero between calls
    int M, int N, int K, int lds, int nk, int fold, int slabs, int gps, int ctas, int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  constexpr int MP = 8 * NT;
  const Layout L(M, gps, stages);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int p = blockIdx.x % slabs, j = blockIdx.x / slabs;
  const int g0 = p * gps, g1 = min(g0 + gps, nk);
  const int nst = (g1 - g0 + GS - 1) / GS;  // stages a tile
  const int T = (N + TILE_N - 1) / TILE_N;
  const int first = j + ctas * warp, step = ctas * WARPS;
  const int nparts = first < T ? (T - 1 - first) / step + 1 : 0;
  const int Q = nparts * nst;  // this warp's stages
  const bool split = slabs > 1;
  // the CTA's busy warps (a prefix) share the ring's WARPS * stages slots
  const int busy = min(WARPS, max(1, (T - j + ctas - 1) / ctas));
  const int st = min(MAX_STAGES, stages * WARPS / busy);
  uint8_t* ring = sm + L.ring + warp * st * STAGE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars) + warp * MAX_STAGES;
  int8_t* xs = reinterpret_cast<int8_t*>(sm + L.x);
  int* corr = reinterpret_cast<int*>(sm + L.corr);
  float* ssx = reinterpret_cast<float*>(sm + L.ssx);
  float* red = reinterpret_cast<float*>(sm + L.red);

  const CUtensorMap* wm = &wmap;
  const CUtensorMap* smp = &smap;
  // lane 0: start this warp's next stage iq (part ipart, stage ik of it)
  // into slot islot: one TMA box of the tile's 16 channels x 4 groups (256
  // bytes a channel) and one of their scales, counted in bytes on the
  // stage's barrier (past the edges: zeros). Stages are started in order.
  int iq = 0, ipart = 0, ik = 0, islot = 0;
  auto issue = [&]() {
    const int row = (first + ipart * step) * TILE_N, gb = g0 + ik * GS;
    uint8_t* dst = ring + islot * STAGE;
    mbar_arrive_expect_tx(&bars[islot], fold ? STAGE : S_OFF);
    tma_load_2d(dst, wm, &bars[islot], gb * GROUP_BYTES, row);
    if (fold) tma_load_2d(dst + S_OFF, smp, &bars[islot], gb, row);
    ++iq;
    if (++ik == nst) ik = 0, ++ipart;
    if (++islot == st) islot = 0;
  };

  // ---- the rows. Their maxima over all of K: thread tid takes 16-byte
  // vectors tid + THREADS i of the rows laid end to end, LOADS at a time,
  // and folds a row's maximum into smax when its vectors move on to the
  // next row; the first batch is asked for before the weights' first
  // stages start. Where all of the rows fit in one batch (M K <= 32k bf16
  // values, whole groups) the thread quantizes the values of this slab that
  // it holds; else the slab is read again. Each group's sum of the
  // quantized row goes to corr by shared-memory reductions.
  constexpr int V = 16 / sizeof(XT);  // values a 16-byte vector
  constexpr int LOADS = 16;           // loads a thread keeps in flight
  const int nv = K / V, total = M * nv, ngx = g1 - g0;
  const bool held = total <= THREADS * LOADS && K % GROUP == 0;
  if (tid == 0) {
    tma_prefetch_map(wm);
    if (fold) tma_prefetch_map(smp);
  }
  uint4 buf[LOADS];
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int f = tid + u * THREADS;
    if (f < total) buf[u] = __ldg(reinterpret_cast<const uint4*>(x) + f);
  }
  unsigned* smax = reinterpret_cast<unsigned*>(red);  // |x| maxima as f32 bits
  if (tid < MP) smax[tid] = 0u;
  for (int i = tid; i < ngx * MP; i += THREADS) corr[i] = 0;
  if (warp < busy && lane == 0) {
    for (int s = 0; s < st; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
    while (iq < min(st, min(split ? nst : Q, Q))) issue();
  }
  __syncthreads();
  {
    int cur = -1;
    float a = 0.f;
    for (int f0 = tid; f0 < total; f0 += THREADS * LOADS) {
      if (f0 != tid) {
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          const int f = f0 + u * THREADS;
          if (f < total) buf[u] = __ldg(reinterpret_cast<const uint4*>(x) + f);
        }
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int f = f0 + u * THREADS;
        if (f < total) {
          const int r = f / nv;
          if (r != cur) {
            if (cur >= 0) red_max(&smax[cur], __float_as_uint(a));
            cur = r, a = 0.f;
          }
          a = fmaxf(a, absmax16<XT>(buf[u]));
        }
      }
    }
    if (cur >= 0) red_max(&smax[cur], __float_as_uint(a));
  }
  __syncthreads();
  if (tid < M) ssx[tid] = row_scale(__uint_as_float(smax[tid]));  // read after the last barrier
  int rp = -1;  // the row whose scale and its reciprocal sx, rs hold
  float sx = 0.f, rs = 0.f;
  auto scale_of = [&](int r) {
    if (r != rp) rp = r, sx = row_scale(__uint_as_float(smax[r])), rs = __frcp_rn(sx);
  };
  if (held) {
    // vector f: row f / nv, values 8 (bf16) or 4 (f32) of one group
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int f = tid + u * THREADS;
      const int r = f < total ? f / nv : 0, k = (f - r * nv) * V, gx = k / GROUP - g0, kg = k % GROUP;
      if (f < total && gx >= 0 && gx < ngx) {  // this slab's groups
        scale_of(r);
        int sum = 0;
        int8_t* xg = xs + gx * GROUP * M + r * GROUP_BYTES + kg / 2;
        if constexpr (V == 8) {
          float v[8];
          values4<XT>(make_uint4(buf[u].x, buf[u].y, 0u, 0u), *reinterpret_cast<float(*)[4]>(v));
          values4<XT>(make_uint4(buf[u].z, buf[u].w, 0u, 0u), *reinterpret_cast<float(*)[4]>(v + 4));
          int q[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) q[e] = quantize_value(v[e], sx, rs), sum += q[e];
          *reinterpret_cast<uint32_t*>(xg) = (q[0] & 0xFF) | (q[2] & 0xFF) << 8 |
                                             (q[4] & 0xFF) << 16 | (uint32_t)(q[6] & 0xFF) << 24;
          *reinterpret_cast<uint32_t*>(xg + GROUP_BYTES * M) =
              (q[1] & 0xFF) | (q[3] & 0xFF) << 8 | (q[5] & 0xFF) << 16 | (uint32_t)(q[7] & 0xFF) << 24;
        } else {
          float v[4];
          values4<XT>(buf[u], v);
          int q[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) q[e] = quantize_value(v[e], sx, rs), sum += q[e];
          *reinterpret_cast<uint16_t*>(xg) = (uint16_t)((q[0] & 0xFF) | (q[2] & 0xFF) << 8);
          *reinterpret_cast<uint16_t*>(xg + GROUP_BYTES * M) =
              (uint16_t)((q[1] & 0xFF) | (q[3] & 0xFF) << 8);
        }
        red_add(&corr[gx * MP + r], -8 * sum);
      }
    }
  } else {
    // this slab's groups, read again: warp w takes (group, row) pairs w +
    // WARPS i, LOADS at a time; lane l the group's values 4l .. 4l + 3
    for (int p0 = warp; p0 < ngx * M; p0 += WARPS * LOADS) {
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int pr = p0 + u * WARPS, gx = pr / M, r = pr - gx * M;
        const int k = (g0 + gx) * GROUP + 4 * lane;
        buf[u] = make_uint4(0u, 0u, 0u, 0u);
        if (pr < ngx * M && k < K) buf[u] = raw4<XT>(x + (size_t)r * K + k);  // K % 4 == 0
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int pr = p0 + u * WARPS, gx = pr / M, r = pr - gx * M;
        if (pr >= ngx * M) break;
        scale_of(r);
        float v[4];
        values4<XT>(buf[u], v);
        int q[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) q[e] = quantize_value(v[e], sx, rs);  // 0 past K
        int8_t* xg = xs + gx * GROUP * M + r * GROUP_BYTES + 2 * lane;
        *reinterpret_cast<uint16_t*>(xg) = (uint16_t)((q[0] & 0xFF) | (q[2] & 0xFF) << 8);
        *reinterpret_cast<uint16_t*>(xg + GROUP_BYTES * M) =
            (uint16_t)((q[1] & 0xFF) | (q[3] & 0xFF) << 8);
        red_add(&corr[gx * MP + r], -8 * (q[0] + q[1] + q[2] + q[3]));
      }
    }
  }
  __syncthreads();
  if (warp >= busy) return;

  // ---- the tiles
  const int rec = (M + 1) * TILE_N;  // floats of one (tile, group) record
  int cslot = 0;                     // the next stage's slot and phase
  uint32_t cphase = 0;
  for (int part = 0; part < nparts; ++part) {
    const int tile = first + part * step, n0 = tile * TILE_N;
    int d[NT][4];
    float fo[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[nt][e] = 0, fo[nt][e] = 0.f;
    }
    float* recs = scratch + (size_t)tile * nk * rec;
    for (int k = 0; k < nst; ++k) {
      const uint8_t* stg = ring + cslot * STAGE;
      wait_stage(&bars[cslot], cphase);
      // the stage's four groups as straight-line code: all of its shared
      // memory reads first, then two product chains a group (k-steps 0, 2
      // from the offset's correction, 1, 3 from 0); groups past the slab
      // (the last stage's) are computed and not used
      const int gb = g0 + k * GS, n = min(GS, g1 - gb);
      uint4 wa[GS], wb[GS];
#pragma unroll
      for (int i = 0; i < GS; ++i) {
        wa[i] = *reinterpret_cast<const uint4*>(stg + g * W_ROW + i * GROUP_BYTES + t * 16);
        wb[i] = *reinterpret_cast<const uint4*>(stg + (g + 8) * W_ROW + i * GROUP_BYTES + t * 16);
      }
      float sa[GS] = {0.f, 0.f, 0.f, 0.f}, sb[GS] = {0.f, 0.f, 0.f, 0.f};
      if (fold) {
        const float4 a4 = *reinterpret_cast<const float4*>(stg + S_OFF + g * 16);
        const float4 b4 = *reinterpret_cast<const float4*>(stg + S_OFF + (g + 8) * 16);
        sa[0] = a4.x, sa[1] = a4.y, sa[2] = a4.z, sa[3] = a4.w;
        sb[0] = b4.x, sb[1] = b4.y, sb[2] = b4.z, sb[3] = b4.w;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int xr = min(8 * nt + g, M - 1);  // B's columns past M: any row
        uint4 xe[GS], xo[GS];
        int2 cr[GS];
#pragma unroll
        for (int i = 0; i < GS; ++i) {
          const int8_t* xg = xs + min(gb + i - g0, ngx - 1) * GROUP * M + xr * GROUP_BYTES + t * 16;
          xe[i] = *reinterpret_cast<const uint4*>(xg);
          xo[i] = *reinterpret_cast<const uint4*>(xg + GROUP_BYTES * M);
          cr[i] = *reinterpret_cast<const int2*>(corr + min(gb + i - g0, ngx - 1) * MP + 8 * nt + 2 * t);
        }
        int acc[GS][4];
#pragma unroll
        for (int i = 0; i < GS; ++i) {
          int c[4] = {cr[i].x, cr[i].y, cr[i].x, cr[i].y}, c2[4] = {0, 0, 0, 0};
          mma_s8(c, lo_offset(wa[i].x), lo_offset(wb[i].x), hi_offset(wa[i].x), hi_offset(wb[i].x),
                 xe[i].x, xo[i].x);
          mma_s8(c2, lo_offset(wa[i].y), lo_offset(wb[i].y), hi_offset(wa[i].y), hi_offset(wb[i].y),
                 xe[i].y, xo[i].y);
          mma_s8(c, lo_offset(wa[i].z), lo_offset(wb[i].z), hi_offset(wa[i].z), hi_offset(wb[i].z),
                 xe[i].z, xo[i].z);
          mma_s8(c2, lo_offset(wa[i].w), lo_offset(wb[i].w), hi_offset(wa[i].w), hi_offset(wb[i].w),
                 xe[i].w, xo[i].w);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = c[e] + c2[e];
        }
        // the groups in order
#pragma unroll
        for (int i = 0; i < GS; ++i) {
          if (i < n) {
            if (!fold) {  // one scale a row: the groups' sums add up
#pragma unroll
              for (int e = 0; e < 4; ++e) d[nt][e] += acc[i][e];
            } else if (!split) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                fo[nt][e] = __fmaf_rn(exact_f32(acc[i][e]), e < 2 ? sa[i] : sb[i], fo[nt][e]);
              }
            } else {  // this group's record: the exact sums, then the scales
              float* rg = recs + (size_t)(gb + i) * rec;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = 8 * nt + 2 * t + (e & 1);
                if (r < M) rg[r * TILE_N + g + 8 * (e >> 1)] = exact_f32(acc[i][e]);
              }
              if (nt == 0 && t == 0) {
                rg[M * TILE_N + g] = sa[i];
                rg[M * TILE_N + g + 8] = sb[i];
              }
            }
          }
        }
      }
      __syncwarp();
      // the slot is read: refill it (within the tile when split: its ring
      // is the fold's buffer at the tile's end)
      if (lane == 0 && iq < (split ? (part + 1) * nst : Q)) issue();
      if (++cslot == st) cslot = 0, cphase ^= 1u;
    }

    if (split) {
      __threadfence();
      __syncwarp();
      int last = 0;
      if (lane == 0) last = atomicAdd(&counters[tile], 1) == slabs - 1;
      if (!__shfl_sync(0xFFFFFFFFu, last, 0)) {
        if (lane == 0) {
          while (iq < min((part + 1) * nst + st, min((part + 2) * nst, Q))) issue();
        }
        continue;
      }
      // the last part of the tile: every group's record, in chunks through
      // this warp's ring, folded in group order
      __threadfence();
      const float* rbuf = reinterpret_cast<const float*>(ring);
      const int chunk = st * STAGE / (rec * 4);
      for (int c0 = 0; c0 < nk; c0 += chunk) {
        const int cn = min(chunk, nk - c0), bytes = cn * rec * 4;
        const uint8_t* src = reinterpret_cast<const uint8_t*>(recs + (size_t)c0 * rec);
        for (int o = lane * 16; o < bytes; o += 32 * 16) cp_async16(ring + o, src + o);
        cp_async_wait_all();
        __syncwarp();
        for (int gi = 0; gi < cn; ++gi) {
          const float* rg = rbuf + gi * rec;
          const float sca = rg[M * TILE_N + g], scb = rg[M * TILE_N + g + 8];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 8 * nt + 2 * t + (e & 1);
              if (r < M) {
                fo[nt][e] = __fmaf_rn(rg[r * TILE_N + g + 8 * (e >> 1)], e < 2 ? sca : scb, fo[nt][e]);
              }
            }
          }
        }
        __syncwarp();
      }
      fence_proxy_async();  // the copies into the ring come before later stages' TMA
      __syncwarp();
      if (lane == 0) counters[tile] = 0;  // ready for the next call
    }

    // rows 8 nt + 2t (+1) of channels n0 + g (+8)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * nt + 2 * t + (e & 1), n = n0 + g + 8 * (e >> 1);
        if (r < M && n < N) {
          const OutT* bn = bias ? bias + n : nullptr;
          if (fold) {
            store_out(out + (size_t)r * N + n, fo[nt][e], ssx[r], bn);
          } else {
            store_out(out + (size_t)r * N + n, __int2float_rn(d[nt][e]), __fmul_rn(ssx[r], ws[(size_t)n * lds]),
                      bn);
          }
        }
      }
    }
    if (split && lane == 0) {
      while (iq < min((part + 1) * nst + st, min((part + 2) * nst, Q))) issue();
    }
  }
}

// ---- host: tensor maps, cached ----------------------------------------------

struct MapKey {
  uintptr_t base;
  uint64_t cols, rows, stride;
  int f32;
  bool operator==(const MapKey& o) const {
    return base == o.base && cols == o.cols && rows == o.rows && stride == o.stride &&
           f32 == o.f32;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<uintptr_t>()(k.base);
    h = h * 1000003u ^ (size_t)k.cols;
    h = h * 1000003u ^ (size_t)k.rows;
    h = h * 1000003u ^ (size_t)k.stride;
    return h * 1000003u ^ (size_t)k.f32;
  }
};

constexpr size_t MAP_CACHE_MAX = 4096;
std::mutex map_mutex;
std::unordered_map<MapKey, CUtensorMap, MapKeyHash> map_cache;

// a 2-d map over [rows, cols] (bytes, or f32 when f32), rows `stride` bytes
// apart (a multiple of 16), boxes of {box_cols, 16 rows}, no swizzle; past
// the edges reads as zeros. Weights are static: a map is encoded once per
// key and kept.
bool cached_map(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                uint64_t stride, bool f32, uint32_t box_cols) {
  const MapKey key{reinterpret_cast<uintptr_t>(base), cols, rows, stride, (int)f32};
  std::lock_guard<std::mutex> lock(map_mutex);
  auto it = map_cache.find(key);
  if (it != map_cache.end()) {
    *map = it->second;
    return true;
  }
  svt_encode_tiled_fn fn = svt_encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box_cols, (cuuint32_t)TILE_N};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
         const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  if (map_cache.size() >= MAP_CACHE_MAX) map_cache.clear();
  map_cache.emplace(key, *map);
  return true;
}

struct Args {
  const void *x, *w, *ws, *bias;
  void* out;
  int ldw, lds, M, N, K, ng, slabs, gps, ctas, stages;
  void *scratch, *counters;
};

template <typename XT, typename OutT, int NT>
cudaError_t launch_nt(const Args& a, cudaStream_t s) {
  const int nk = (a.K + GROUP - 1) / GROUP;
  const bool fold = a.ng > 1;
  CUtensorMap wmap, smap;
  if (!cached_map(&wmap, a.w, (uint64_t)a.K / 2, (uint64_t)a.N, (uint64_t)a.ldw, false, W_ROW) ||
      (fold && !cached_map(&smap, a.ws, (uint64_t)a.ng, (uint64_t)a.N, (uint64_t)a.lds * 4, true,
                           GS))) {
    return cudaErrorInvalidValue;
  }
  if (!fold) smap = wmap;  // not read
  const Layout L(a.M, a.gps, a.stages);
  static int opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (L.total > opted) {
    const cudaError_t e = cudaFuncSetAttribute(int4_gemv_kernel<XT, OutT, NT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return e;
    opted = L.total;
  }
  int4_gemv_kernel<XT, OutT, NT><<<a.slabs * a.ctas, THREADS, L.total, s>>>(
      wmap, smap, (const XT*)a.x, (const float*)a.ws, (const OutT*)a.bias, (OutT*)a.out,
      (float*)a.scratch, (int*)a.counters, a.M, a.N, a.K, a.lds, nk, (int)fold, a.slabs, a.gps,
      a.ctas, a.stages);
  return cudaSuccess;
}

template <typename XT, typename OutT>
cudaError_t launch(const Args& a, cudaStream_t s) {
  switch (row_tiles(a.M)) {
    case 1: return launch_nt<XT, OutT, 1>(a, s);
    case 2: return launch_nt<XT, OutT, 2>(a, s);
    default: return launch_nt<XT, OutT, 4>(a, s);
  }
}

}  // namespace

// the most rows K5-int4 takes (qdot4 dequantizes above it)
extern "C" int svt_int4_max_rows() { return MAX_ROWS; }

// qdot4 at M <= MAX_ROWS: x [M, K] (bf16 if x_bf16 else f32), packed weight
// [N, K / 2] int8 with rows ldw bytes apart (a multiple of 16), scales [N,
// ng] f32 with rows lds floats apart (ng > 1: a multiple of 4; ng = K / 128
// when 128 divides K, else 1) -> out [M, N] (bf16 if out_bf16 else f32), +
// bias [N] in the output type when not null. The plan (ops/quant.py
// `int4_plan`): K's 128-row groups in `slabs` slabs of `gps` groups, `ctas`
// CTAs a slab, `stages` ring stages a warp; slabs > 1 needs ng > 1,
// `scratch` (T * nk * (M + 1) * 16 floats, T = ceil(N / 16)) and `counters`
// (T ints, zero). K must be a multiple of 8; every pointer 16-byte aligned.
extern "C" int svt_qdot4(const void* x, int x_bf16, const void* w, int ldw, const void* ws,
                         int lds, const void* bias, void* out, int out_bf16, int M, int N, int K,
                         int ng, int slabs, int gps, int ctas, int stages, void* scratch,
                         void* counters, void* stream) {
  const int nk = (K + GROUP - 1) / GROUP;
  if (M < 1 || M > MAX_ROWS || N < 1 || K < 8 || K % 8 != 0 ||
      ng != (K % GROUP == 0 ? K / GROUP : 1) || ldw % 16 != 0 || ldw < (K / 2 + 15) / 16 * 16 ||
      (ng > 1 && (lds % 4 != 0 || lds < (ng + 3) / 4 * 4)) || slabs < 1 || gps < 1 || (slabs - 1) * gps >= nk ||
      slabs * gps < nk || (slabs > 1 && (ng == 1 || gps % GS != 0 || !scratch || !counters)) ||
      ctas < 1 || stages < 2 || stages > MAX_STAGES || Layout(M, gps, stages).total > SMEM_CAP) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, w, ws, bias, out, ldw, lds, M, N, K, ng, slabs, gps, ctas, stages, scratch,
               counters};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_bf16 && out_bf16) {
    e = launch<bf16, bf16>(a, s);
  } else if (x_bf16) {
    e = launch<bf16, float>(a, s);
  } else if (out_bf16) {
    e = launch<float, bf16>(a, s);
  } else {
    e = launch<float, float>(a, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
