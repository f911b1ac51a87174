// Backward of causal GQA self-attention (kernel K1-bwd of the port), the
// gradient half of training's attention, written for the H100.
//
// It replaces no pl.pallas_call: the JAX package trains through XLA's
// autodiff of `_gqa_attention_chunked` (streaming_vlm_tpu/models/qwen25_vl/
// language.py:147-200). Its forward here is K1 at visible 0
// (csrc/prefill_attention.cu), which also writes each query row's log2-space
// log-sum-exp lse2; from the saved output O and lse2 this computes, for
// q [T, H, HD], k and v [T, Hkv, HD] (bf16, q and k rotated) and the output's
// gradient dO [T, H, HD] (bf16):
//   s2 = (q . k) * softmax-scale * log2(e)    (f32, from the bf16 q and k)
//   P = exp2(s2 - lse2), causal (key j <= token t)
//   D = rowsum(dO * O)                         (f32)
//   dP = dO . v, dS = P * (dP - D)             (the gradient of the natural logits)
//   dQ = dS . k * scale, dK = dS^T . q * scale, dV = P^T . dO
// with dK and dV summed over the G query heads of each kv head, f32
// accumulation and bf16 outputs. Rows are K1's packed GQA rows: row r of a
// kv head is (token r / G, head r % G), so all G heads of a kv head share
// every staged K/V tile and G is only a row count.
//
// What bounds it on an H100: operations. At T = 8192 (H 28, Hkv 4, HD 128)
// the five products over the causal half are 5 * 2 * H * HD * T (T + 1) / 2
// = 1.20 TFLOP, 1.21 ms at the bf16 tensor-core peak, against ~0.5 GB of
// inputs and outputs (0.15 ms). What this first, simple design does:
//   * three launches, no atomics, so a call is bitwise repeatable (training
//     resumes bit for bit): a pass for D; a dK/dV kernel, one CTA per (kv
//     head, 64-key block), looping over the packed query rows that see the
//     block (from the diagonal down) 32 at a time; a dQ kernel, one CTA per
//     (kv head, 64-row block), looping over the key blocks up to the
//     diagonal. Each recomputes S and dP, so the card does 7 products where
//     the bound counts 5;
//   * every product is mma.sync m16n8k16 (bf16 in, f32 accumulate), one
//     warp a 16-row (or 16-key) slice; S and dP stay in registers, and P
//     and dS, rounded to bf16, go from the accumulator layout straight into
//     the A operand of the next product (the FA2 register layout); B
//     operands come from shared memory by ldmatrix (.trans where the tile is
//     stored K-major the other way);
//   * tiles are staged by cp.async, double-buffered, in rows of 256 bytes
//     whose 16-byte chunks are XOR-swizzled with the row (so the 8 rows of
//     an ldmatrix fall on distinct banks); rows past T (keys) or past T G
//     (query rows) arrive as zeros, and every weight outside the causal
//     triangle is selected to 0 (never multiplied: 0 * a stale value could
//     be NaN);
//   * the heaviest blocks launch first: key block 0 of the dK/dV kernel
//     (every row sees it) and the last row block of the dQ kernel.
// It is slower than its bound (on an NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py phase 3: 12.8 ms of device time at T = 8192, 9.5% of the
// 1.21 ms; SDPA's causal forward + backward takes 3.1 ms): no wgmma, no TMA,
// 8 warps an SM, and the two recomputed products; a later redesign can take
// FA3's shape (wgmma, a producer warp, dQ through a second pass over f32
// partials).
//
// Built by nvcc for sm_90a into the port's plain-C shared library (see
// streaming_vlm_tpu_torch/ops/_kernels.py); the entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int HD = 128;          // head dim (the wrapper rejects others)
constexpr int ROW = HD * 2;      // bytes of a staged row
constexpr int THREADS = 128;     // 4 warps
constexpr int KV_KEYS = 64;      // keys a dK/dV CTA owns (16 a warp)
constexpr int KV_ROWS = 32;      // packed query rows a dK/dV step stages
constexpr int Q_ROWS = 64;       // packed query rows a dQ CTA owns (16 a warp)
constexpr int Q_KEYS = 64;       // keys a dQ step stages
constexpr int KV_SMEM = 2 * KV_KEYS * ROW + 2 * (2 * KV_ROWS * ROW + 2 * KV_ROWS * 4);
constexpr int Q_SMEM = 2 * Q_ROWS * ROW + 2 * (2 * Q_KEYS * ROW);

// byte offset of 16-byte chunk c of row r in a staged tile
__device__ __forceinline__ int swz(int r, int c) { return r * ROW + ((c ^ (r & 7)) << 4); }

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// rows [r0, r0 + n) of a kv head's packed rows of x [T, H, HD] -> a staged
// tile (zeros past R = T G)
__device__ __forceinline__ void stage_rows(unsigned char* tile, const bf16* __restrict__ x, int r0,
                                           int n, int R, int H, int kvh, int G) {
  for (int i = threadIdx.x; i < n * (HD / 8); i += THREADS) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    const int gr = r0 + r;
    const bool ok = gr < R;
    const int t = ok ? gr / G : 0, g = ok ? gr - t * G : 0;
    cp16(tile + swz(r, c), x + ((size_t)t * H + kvh * G + g) * HD + c * 8, ok);
  }
}

// keys [k0, k0 + n) of a kv head of x [T, Hkv, HD] -> a staged tile (zeros
// past T)
__device__ __forceinline__ void stage_keys(unsigned char* tile, const bf16* __restrict__ x, int k0,
                                           int n, int T, int Hkv, int kvh) {
  for (int i = threadIdx.x; i < n * (HD / 8); i += THREADS) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    const bool ok = k0 + r < T;
    cp16(tile + swz(r, c), x + ((size_t)(ok ? k0 + r : 0) * Hkv + kvh) * HD + c * 8, ok);
  }
}

// D = rowsum(dO * O) in f32, one warp a (token, head) row
__global__ void attn_bwd_dot_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                    float* __restrict__ dsum, int rows) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint2 a = *reinterpret_cast<const uint2*>(o + (size_t)row * HD + lane * 4);
  const uint2 b = *reinterpret_cast<const uint2*>(dout + (size_t)row * HD + lane * 4);
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(b2[e]);
    s += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) dsum[row] = s;
}

// dK and dV of one (kv head, 64-key block): warp w owns keys k0 + 16 w ..
// + 16; each step stages 32 packed query rows (q, dO, their lse2 and D).
__global__ void __launch_bounds__(THREADS, 2) attn_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H, int Hkv, int G, float qscale,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sK = smem;
  unsigned char* sV = sK + KV_KEYS * ROW;
  unsigned char* sQ = sV + KV_KEYS * ROW;        // [2][KV_ROWS rows]
  unsigned char* sO = sQ + 2 * KV_ROWS * ROW;    // dO, [2][KV_ROWS rows]
  float* sL = reinterpret_cast<float*>(sO + 2 * KV_ROWS * ROW);  // [2][KV_ROWS]
  float* sD = sL + 2 * KV_ROWS;

  const int kvh = blockIdx.x, k0 = blockIdx.y * KV_KEYS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int R = T * G;
  const int r_begin = (k0 * G) / KV_ROWS * KV_ROWS;  // the first rows that see a key of the block
  const int n_steps = (R - r_begin + KV_ROWS - 1) / KV_ROWS;

  auto stage_step = [&](int s, int buf) {
    const int r0 = r_begin + s * KV_ROWS;
    stage_rows(sQ + buf * KV_ROWS * ROW, q, r0, KV_ROWS, R, H, kvh, G);
    stage_rows(sO + buf * KV_ROWS * ROW, dout, r0, KV_ROWS, R, H, kvh, G);
    if (threadIdx.x < KV_ROWS) {
      const int gr = r0 + threadIdx.x;
      const bool ok = gr < R;
      const int t = ok ? gr / G : 0, g = ok ? gr - t * G : 0;
      const size_t idx = (size_t)t * H + kvh * G + g;
      cp4(sL + buf * KV_ROWS + threadIdx.x, lse + idx, ok);
      cp4(sD + buf * KV_ROWS + threadIdx.x, dsum + idx, ok);
    }
  };

  stage_keys(sK, k, k0, KV_KEYS, T, Hkv, kvh);
  stage_keys(sV, v, k0, KV_KEYS, T, Hkv, kvh);
  stage_step(0, 0);
  cp_commit();

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  }
  const int ja = k0 + 16 * warp + g4, jb = ja + 8;  // this thread's keys (rows g4, g4 + 8)
  // ldmatrix row addresses: A (keys of the warp) and non-transposed B
  // (rows of the step), and the transposed B of the step's rows
  const int a_row = 16 * warp + (lane % 8) + ((lane / 8) % 2) * 8, a_chunk = lane / 16;
  const int b_row = (lane % 8) + (lane / 16) * 8, b_chunk = (lane / 8) % 2;
  const int bt_row = (lane % 8) + ((lane / 8) % 2) * 8, bt_chunk = lane / 16;

  for (int s = 0; s < n_steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_steps) {
      stage_step(s + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const unsigned char* tq = sQ + buf * KV_ROWS * ROW;
    const unsigned char* to = sO + buf * KV_ROWS * ROW;
    const float* tl = sL + buf * KV_ROWS;
    const float* td = sD + buf * KV_ROWS;
    const int r0 = r_begin + s * KV_ROWS;

    // S^T = K q^T and dP^T = V dO^T: [16 keys of the warp, 32 rows]
    float st[KV_ROWS / 8][4], dpt[KV_ROWS / 8][4];
#pragma unroll
    for (int n = 0; n < KV_ROWS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldmatrix_x4(ak, sK + swz(a_row, 2 * kk + a_chunk));
      ldmatrix_x4(av, sV + swz(a_row, 2 * kk + a_chunk));
#pragma unroll
      for (int nn = 0; nn < KV_ROWS / 16; ++nn) {
        uint32_t b[4];
        ldmatrix_x4(b, tq + swz(16 * nn + b_row, 2 * kk + b_chunk));
        mma_m16n8k16_bf16(st[2 * nn], ak, b[0], b[1]);
        mma_m16n8k16_bf16(st[2 * nn + 1], ak, b[2], b[3]);
        ldmatrix_x4(b, to + swz(16 * nn + b_row, 2 * kk + b_chunk));
        mma_m16n8k16_bf16(dpt[2 * nn], av, b[0], b[1]);
        mma_m16n8k16_bf16(dpt[2 * nn + 1], av, b[2], b[3]);
      }
    }
    // P^T and dS^T in place; key j sees packed row r when j <= r / G
#pragma unroll
    for (int n = 0; n < KV_ROWS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = 8 * n + 2 * t4 + (e & 1);
        const int r = r0 + rl;
        const int key = (e & 2) ? jb : ja;
        const bool ok = r < R && key <= r / G;
        const float p = ok ? exp2f(st[n][e] * qscale - tl[rl]) : 0.f;
        dpt[n][e] = ok ? p * (dpt[n][e] - td[rl]) : 0.f;
        st[n][e] = p;
      }
    }
    // dV += P^T dO, dK += dS^T q over the step's 32 rows (2 k-steps)
#pragma unroll
    for (int kk = 0; kk < KV_ROWS / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, to + swz(16 * kk + bt_row, 2 * nn + bt_chunk));
        mma_m16n8k16_bf16(dva[2 * nn], pa, b[0], b[1]);
        mma_m16n8k16_bf16(dva[2 * nn + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, tq + swz(16 * kk + bt_row, 2 * nn + bt_chunk));
        mma_m16n8k16_bf16(dka[2 * nn], da, b[0], b[1]);
        mma_m16n8k16_bf16(dka[2 * nn + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is staged again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = h ? jb : ja;
    if (j >= T) continue;
    bf16* krow = dk + ((size_t)j * Hkv + kvh) * HD + 2 * t4;
    bf16* vrow = dv + ((size_t)j * Hkv + kvh) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(krow + 8 * n) =
          pack_bf16(dka[n][2 * h] * scale, dka[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * n) = pack_bf16(dva[n][2 * h], dva[n][2 * h + 1]);
    }
  }
}

// dQ of one (kv head, 64-row block): warp w owns packed rows r0 + 16 w ..
// + 16; each step stages 64 keys of K and V, up to the block's last token.
__global__ void __launch_bounds__(THREADS, 2) attn_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
    bf16* __restrict__ dq, int T, int H, int Hkv, int G, float qscale, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sO = sQ + Q_ROWS * ROW;
  unsigned char* sK = sO + Q_ROWS * ROW;  // [2][Q_KEYS rows]
  unsigned char* sV = sK + 2 * Q_KEYS * ROW;

  const int kvh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * Q_ROWS;  // the heaviest blocks first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int R = T * G;
  const int n_steps = (min(R, r0 + Q_ROWS) - 1) / G / Q_KEYS + 1;

  stage_rows(sQ, q, r0, Q_ROWS, R, H, kvh, G);
  stage_rows(sO, dout, r0, Q_ROWS, R, H, kvh, G);
  stage_keys(sK, k, 0, Q_KEYS, T, Hkv, kvh);
  stage_keys(sV, v, 0, Q_KEYS, T, Hkv, kvh);
  cp_commit();

  // this thread's rows (g4, g4 + 8 of the warp's 16), their tokens, lse2 and D
  int rr[2], tt[2];
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rr[h] = r0 + 16 * warp + g4 + 8 * h;
    const bool ok = rr[h] < R;
    tt[h] = ok ? rr[h] / G : 0;
    const size_t idx = (size_t)tt[h] * H + kvh * G + (ok ? rr[h] - tt[h] * G : 0);
    l2[h] = ok ? lse[idx] : 0.f;
    dd[h] = ok ? dsum[idx] : 0.f;
  }
  float dqa[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  }
  const int a_row = 16 * warp + (lane % 8) + ((lane / 8) % 2) * 8, a_chunk = lane / 16;
  const int b_row = (lane % 8) + (lane / 16) * 8, b_chunk = (lane / 8) % 2;
  const int bt_row = (lane % 8) + ((lane / 8) % 2) * 8, bt_chunk = lane / 16;

  for (int s = 0; s < n_steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_steps) {
      stage_keys(sK + (buf ^ 1) * Q_KEYS * ROW, k, (s + 1) * Q_KEYS, Q_KEYS, T, Hkv, kvh);
      stage_keys(sV + (buf ^ 1) * Q_KEYS * ROW, v, (s + 1) * Q_KEYS, Q_KEYS, T, Hkv, kvh);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const unsigned char* tk = sK + buf * Q_KEYS * ROW;
    const unsigned char* tv = sV + buf * Q_KEYS * ROW;
    const int k0 = s * Q_KEYS;

    // S = q K^T and dP = dO V^T: [16 rows of the warp, 64 keys]
    float sa[Q_KEYS / 8][4], dp[Q_KEYS / 8][4];
#pragma unroll
    for (int n = 0; n < Q_KEYS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldmatrix_x4(aq, sQ + swz(a_row, 2 * kk + a_chunk));
      ldmatrix_x4(ao, sO + swz(a_row, 2 * kk + a_chunk));
#pragma unroll
      for (int nn = 0; nn < Q_KEYS / 16; ++nn) {
        uint32_t b[4];
        ldmatrix_x4(b, tk + swz(16 * nn + b_row, 2 * kk + b_chunk));
        mma_m16n8k16_bf16(sa[2 * nn], aq, b[0], b[1]);
        mma_m16n8k16_bf16(sa[2 * nn + 1], aq, b[2], b[3]);
        ldmatrix_x4(b, tv + swz(16 * nn + b_row, 2 * kk + b_chunk));
        mma_m16n8k16_bf16(dp[2 * nn], ao, b[0], b[1]);
        mma_m16n8k16_bf16(dp[2 * nn + 1], ao, b[2], b[3]);
      }
    }
    // dS in place of S
#pragma unroll
    for (int n = 0; n < Q_KEYS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int key = k0 + 8 * n + 2 * t4 + (e & 1);
        const bool ok = rr[h] < R && key <= tt[h];
        const float p = ok ? exp2f(sa[n][e] * qscale - l2[h]) : 0.f;
        sa[n][e] = ok ? p * (dp[n][e] - dd[h]) : 0.f;
      }
    }
    // dQ += dS K over the step's 64 keys (4 k-steps)
#pragma unroll
    for (int kk = 0; kk < Q_KEYS / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(sa[2 * kk][0], sa[2 * kk][1]),
                              pack_bf16(sa[2 * kk][2], sa[2 * kk][3]),
                              pack_bf16(sa[2 * kk + 1][0], sa[2 * kk + 1][1]),
                              pack_bf16(sa[2 * kk + 1][2], sa[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, tk + swz(16 * kk + bt_row, 2 * nn + bt_chunk));
        mma_m16n8k16_bf16(dqa[2 * nn], da, b[0], b[1]);
        mma_m16n8k16_bf16(dqa[2 * nn + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is staged again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rr[h] >= R) continue;
    const int g = rr[h] - tt[h] * G;
    bf16* qrow = dq + ((size_t)tt[h] * H + kvh * G + g) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(qrow + 8 * n) =
          pack_bf16(dqa[n][2 * h] * scale, dqa[n][2 * h + 1] * scale);
    }
  }
}

}  // namespace

// K1-bwd. q, o, dout, dq [T, H, HD]; k, v, dk, dv [T, Hkv, HD] (bf16,
// contiguous); lse [T, H] f32 (log2 space, as K1 writes it); dsum [T, H]
// f32 scratch for D. Three launches on `stream`; no atomics.
extern "C" int svt_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* lse, const void* dout, void* dsum, void* dq, void* dk,
                                 void* dv, int T, int H, int Hkv, int hd, void* stream) {
  if (hd != HD || Hkv <= 0 || H % Hkv != 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf((float)hd);
  const float qscale = 1.4426950408889634f * scale;
  const int rows = T * H;
  attn_bwd_dot_kernel<<<(rows + 7) / 8, 256, 0, st>>>((const bf16*)o, (const bf16*)dout,
                                                      (float*)dsum, rows);
  cudaFuncSetAttribute(attn_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM);
  attn_bwd_dkdv_kernel<<<dim3(Hkv, (T + KV_KEYS - 1) / KV_KEYS), THREADS, KV_SMEM, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)dsum, (bf16*)dk, (bf16*)dv, T, H, Hkv, G, qscale, scale);
  cudaFuncSetAttribute(attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM);
  attn_bwd_dq_kernel<<<dim3(Hkv, (T * G + Q_ROWS - 1) / Q_ROWS), THREADS, Q_SMEM, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)dsum, (bf16*)dq, T, H, Hkv, G, qscale, scale);
  return (int)cudaGetLastError();
}
