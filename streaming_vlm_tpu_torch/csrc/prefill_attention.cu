// Chunk-prefill attention over the streaming KV arena plus the chunk's own
// block (kernel K1 of the port).
//
// Replaces the TPU kernel streaming_vlm_tpu/ops/attention.py
// `streaming_prefill_attention` / `_flash_kernel`: GQA flash attention of a
// T-token chunk over two KV sources under ONE online softmax in log2/exp2
// form. Arena slots < visible_len are visible with no causal mask; the
// chunk's own block is causal. The arena K is either pre-rotated (the
// engine's mode) or raw and rotated here from per-slot duplicated-half
// cos/sin (ROTATE=true).
//
// What bounds it on an H100: at the slice's T=640 (bucket) and an arena of
// ~9k visible slots, each CTA re-reads the visible arena once per 64 query
// rows, so the work is ~2*T*G*Hkv*(visible+T)*hd*2 flops (~37 GFLOP per
// layer at 7B) against ~10 MB of arena bytes per layer: compute-bound.
// This first version keeps the design simple and correct:
//   * one CTA per (kv head, tile of BM=64 query rows); the G query heads of
//     that kv head are packed as rows (row r -> token r / G, head r % G), so
//     a group size that is not a power of two (G=7 at 7B) is only a
//     different row count, with the ragged last tile masked;
//   * arena tiles are visited only up to ceil(visible_len / BN) and self
//     tiles only up to the CTA's causal limit: invisible tiles are never
//     loaded;
//   * both products use bf16 WMMA (16x16x16, f32 accumulate) from shared
//     memory; the running (m, l) and the f32 output accumulator live in
//     shared memory. wgmma/TMA pipelining is later work.
//
// Built by nvcc for sm_90a into a plain-C shared library (see
// streaming_vlm_tpu_torch/ops/_kernels.py); the launch returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int HD = 128;           // head dim (the wrapper rejects others)
constexpr int BM = 64;            // query rows per CTA
constexpr int BN = 64;            // keys per tile
constexpr int WARPS = 4;          // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int LDB = HD + 8;       // bf16 row stride of the Q/K/V tiles
constexpr int LDP = BN + 8;       // bf16 row stride of P
constexpr int LDS = BN + 4;       // f32 row stride of S
constexpr int LDO = HD + 4;       // f32 row stride of O

constexpr size_t SMEM_BYTES =
    sizeof(bf16) * (BM * LDB + 2 * BN * LDB + BM * LDP) +
    sizeof(float) * (BM * LDS + BM * LDO + 2 * BM);

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

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// Load one BN-key tile of K and V (rows [j0, j0 + BN) of a [n, Hkv, HD]
// source) into shared memory; keys >= n_keys are zero-filled so that masked
// columns can never carry NaN/Inf garbage into P @ V. With ROTATE the K rows
// are rotated in f32 from per-slot cos/sin [n, HD] and rounded to bf16.
template <bool ROTATE>
__device__ __forceinline__ void load_kv_tile(
    bf16* sK, bf16* sV, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ cos2, const float* __restrict__ sin2,
    int j0, int n_keys, int Hkv, int kvh, int tid) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BN * (HD / 8); i += THREADS) {
    const int r = i / (HD / 8);
    const int c8 = (i % (HD / 8)) * 8;
    const int key = j0 + r;
    uint4 vv = zero;
    if (key < n_keys) {
      vv = *reinterpret_cast<const uint4*>(v + ((size_t)key * Hkv + kvh) * HD + c8);
    }
    *reinterpret_cast<uint4*>(sV + r * LDB + c8) = vv;
    if (!ROTATE) {
      uint4 kk = zero;
      if (key < n_keys) {
        kk = *reinterpret_cast<const uint4*>(k + ((size_t)key * Hkv + kvh) * HD + c8);
      }
      *reinterpret_cast<uint4*>(sK + r * LDB + c8) = kk;
    }
  }
  if (ROTATE) {
    constexpr int H2 = HD / 2;
    for (int i = tid; i < BN * (H2 / 8); i += THREADS) {
      const int r = i / (H2 / 8);
      const int c8 = (i % (H2 / 8)) * 8;
      const int key = j0 + r;
      uint4 lo = zero, hi = zero;
      if (key < n_keys) {
        const bf16* row = k + ((size_t)key * Hkv + kvh) * HD;
        const float* cr = cos2 + (size_t)key * HD;
        const float* sr = sin2 + (size_t)key * HD;
        float a[8], b[8], o1[8], o2[8];
        unpack8(*reinterpret_cast<const uint4*>(row + c8), a);
        unpack8(*reinterpret_cast<const uint4*>(row + H2 + c8), b);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          // duplicated-half convention: rot = cat(-k2, k1)
          o1[e] = a[e] * cr[c8 + e] - b[e] * sr[c8 + e];
          o2[e] = b[e] * cr[H2 + c8 + e] + a[e] * sr[H2 + c8 + e];
        }
        lo = pack8(o1);
        hi = pack8(o2);
      }
      *reinterpret_cast<uint4*>(sK + r * LDB + c8) = lo;
      *reinterpret_cast<uint4*>(sK + r * LDB + H2 + c8) = hi;
    }
  }
}

template <bool ROTATE>
__global__ void __launch_bounds__(THREADS) prefill_attention_kernel(
    const bf16* __restrict__ q,       // [T, H, HD]
    const bf16* __restrict__ ka,      // [C, Hkv, HD]
    const bf16* __restrict__ va,      // [C, Hkv, HD]
    const float* __restrict__ acos2,  // [C, HD] (ROTATE only)
    const float* __restrict__ asin2,
    const bf16* __restrict__ ks,      // [T, Hkv, HD] rotated self block
    const bf16* __restrict__ vs,
    bf16* __restrict__ out,           // [T, H, HD]
    int T, int H, int Hkv, int G, int visible_len, float qscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * LDB;
  bf16* sV = sK + BN * LDB;
  bf16* sP = sV + BN * LDB;
  float* sS = reinterpret_cast<float*>(sP + BM * LDP);
  float* sO = sS + BM * LDS;
  float* sM = sO + BM * LDO;
  float* sL = sM + BM;

  const int kvh = blockIdx.x;
  const int r0 = blockIdx.y * BM;
  const int R = T * G;  // packed (token, group-head) rows
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // Q tile: scaled by softmax-scale * log2(e) in f32, then rounded to bf16
  // for the tensor cores (the TPU kernel folds the same factor into q).
  for (int i = tid; i < BM * (HD / 8); i += THREADS) {
    const int r = i / (HD / 8);
    const int c8 = (i % (HD / 8)) * 8;
    const int gr = r0 + r;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (gr < R) {
      const int t = gr / G;
      const int g = gr - t * G;
      unpack8(*reinterpret_cast<const uint4*>(q + ((size_t)t * H + kvh * G + g) * HD + c8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= qscale;
    }
    *reinterpret_cast<uint4*>(sQ + r * LDB + c8) = pack8(f);
  }
  for (int i = tid; i < BM * HD; i += THREADS) sO[(i / HD) * LDO + (i % HD)] = 0.f;
  for (int i = tid; i < BM; i += THREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }

  const int n_arena_tiles = (visible_len + BN - 1) / BN;
  const int t_last = (min(r0 + BM, R) - 1) / G;  // highest query token here
  const int n_self_tiles = t_last / BN + 1;

  for (int it = 0; it < n_arena_tiles + n_self_tiles; ++it) {
    const bool arena = it < n_arena_tiles;
    const int j0 = (arena ? it : it - n_arena_tiles) * BN;
    __syncthreads();  // previous tile's K/V/P reads are done
    if (arena) {
      load_kv_tile<ROTATE>(sK, sV, ka, va, acos2, asin2, j0, visible_len, Hkv, kvh, tid);
    } else {
      load_kv_tile<false>(sK, sV, ks, vs, nullptr, nullptr, j0, T, Hkv, kvh, tid);
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BN keys (log2-space logits)
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + warp * 16 * LDB + kk, LDB);
#pragma unroll
        for (int n = 0; n < BN / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, sK + n * 16 * LDB + kk, LDB);
          wmma::mma_sync(acc[n], a, b, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) {
        wmma::store_matrix_sync(sS + warp * 16 * LDS + n * 16, acc[n], LDS, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // online softmax over this warp's rows; lane owns columns lane, lane+32
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int gr = r0 + r;
      const int t = gr / G;
      const int c0 = j0 + lane;
      const int c1 = c0 + 32;
      bool v0, v1;
      if (arena) {
        v0 = c0 < visible_len;
        v1 = c1 < visible_len;
      } else {
        v0 = c0 <= t && c0 < T;
        v1 = c1 <= t && c1 < T;
      }
      v0 = v0 && gr < R;
      v1 = v1 && gr < R;
      const float s0 = v0 ? sS[r * LDS + lane] : -INFINITY;
      const float s1 = v1 ? sS[r * LDS + lane + 32] : -INFINITY;
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = v0 ? exp2f(s0 - m_new) : 0.f;
      const float p1 = v1 ? exp2f(s1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      const float alpha = (m_old == -INFINITY) ? 0.f : exp2f(m_old - m_new);
      sP[r * LDP + lane] = __float2bfloat16(p0);
      sP[r * LDP + lane + 32] = __float2bfloat16(p1);
#pragma unroll
      for (int d = lane; d < HD; d += 32) sO[r * LDO + d] *= alpha;
      __syncwarp();  // every lane has read sM[r] / sL[r]
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + psum;
      }
      __syncwarp();
    }

    // O += P V for this warp's rows
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, sO + warp * 16 * LDO + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + warp * 16 * LDP + kk, LDP);
        wmma::load_matrix_sync(b, sV + kk * LDB + n * 16, LDB);
        wmma::mma_sync(o, a, b, o);
      }
      wmma::store_matrix_sync(sO + warp * 16 * LDO + n * 16, o, LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = tid; i < BM * HD; i += THREADS) {
    const int r = i / HD;
    const int d = i % HD;
    const int gr = r0 + r;
    if (gr < R) {
      const int t = gr / G;
      const int g = gr - t * G;
      const float o = sO[r * LDO + d] / fmaxf(sL[r], 1e-20f);
      out[((size_t)t * H + kvh * G + g) * HD + d] = __float2bfloat16(o);
    }
  }
}

}  // namespace

extern "C" int svt_prefill_attention(
    const void* q, const void* ka, const void* va, const void* acos2,
    const void* asin2, const void* ks, const void* vs, void* out, int T, int H,
    int Hkv, int hd, int visible_len, void* stream) {
  if (hd != HD || H % Hkv != 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  const float qscale = 1.4426950408889634f / sqrtf((float)hd);
  const dim3 grid(Hkv, (T * G + BM - 1) / BM);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (acos2 != nullptr) {
    cudaFuncSetAttribute(prefill_attention_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    prefill_attention_kernel<true><<<grid, THREADS, SMEM_BYTES, s>>>(
        (const bf16*)q, (const bf16*)ka, (const bf16*)va, (const float*)acos2,
        (const float*)asin2, (const bf16*)ks, (const bf16*)vs, (bf16*)out, T, H,
        Hkv, G, visible_len, qscale);
  } else {
    cudaFuncSetAttribute(prefill_attention_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    prefill_attention_kernel<false><<<grid, THREADS, SMEM_BYTES, s>>>(
        (const bf16*)q, (const bf16*)ka, (const bf16*)va, nullptr, nullptr,
        (const bf16*)ks, (const bf16*)vs, (bf16*)out, T, H, Hkv, G, visible_len,
        qscale);
  }
  return (int)cudaGetLastError();
}
