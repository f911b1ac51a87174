// Single-token decode attention over the RAW (un-rotated) arena, read in its
// storage form, + the decode delta + self, under one joint softmax: kernel
// K3 of the port.
//
// Replaces the TPU kernel streaming_vlm_tpu/ops/attention.py
// `streaming_decode_attention_int8` / `_decode_int8_kernel`. The arena K/V
// are either int8 with per-(slot, kv head) f32 scales or bf16 (one template,
// QUANT); each slot's mRoPE angles are built in the kernel from its [3]
// positions and the [3, HD/2] masked inverse-frequency table:
//   ang[c, ch] = pos[c,0] * f0[ch] + pos[c,1] * f1[ch] + pos[c,2] * f2[ch]
// (two of the three terms are exact zeros, so this is the single product
// that the plain version computes), and K is rotated with the
// duplicated-half convention (channel ch pairs with ch + HD/2).
//
// Dtype chain, as the plain version (dequantize to the compute dtype, then
// rotate in f32, then cast): k = bf16(q8 * s) -> r = bf16(k1*cos - k2*sin,
// k2*cos + k1*sin) with each product and sum rounded separately (no FMA
// contraction, as PyTorch's elementwise ops) -> dot with the f32 query.
// V is bf16(q8 * s). sin/cos are `sincosf` with full range reduction: append
// mode grows positions without bound, and the fast intrinsics' error grows
// with |x|.
//
// What bounds it on an H100: bytes. At visible_len = 9000 an int8 arena
// layer is 9000 x 4 x 128 x 2 B of K+V plus 288 KB of scales and 108 KB of
// positions, ~9.6 MB, against ~0.3 GFLOP and 9000 x 64 sin/cos. Design: the
// split-K scheme with one CTA per split of SPLIT=64 slots covering ALL kv
// heads, so each slot's 64 sin/cos pairs are computed once per call (not
// once per kv head) into shared memory, laid out [channel][slot] so that
// the 32 lanes of a warp (one slot each) read them without bank conflicts.
// Warp w then takes kv heads w, w+4, ...: lane = slot for Q.K (the lane
// holds both halves of every channel pair of its key, so the rotation needs
// no shuffles; 16-byte loads of 16 int8 or 8 bf16 channels), lane = head-dim
// slice for P.V. The partials have the layout of decode_common.cuh; a
// second launch (decode_combine_kernel) folds them with the small delta +
// self block.

#include "decode_common.cuh"

namespace {

constexpr int HALF = HD / 2;
constexpr int SPLIT = 64;      // arena slots per split: split s covers [s * SPLIT, (s + 1) * SPLIT)
constexpr int THREADS = 128;   // 4 warps; the combine maps one thread per head-dim lane
constexpr int NWARPS = THREADS / 32;

// One online-softmax step of a warp over 32 keys (lane = key): fold the
// logits s[g] (invalid lanes masked) into the running (m, l, acc) and return
// the weights p[g] that P.V multiplies (0 for invalid lanes).
__device__ __forceinline__ void online_softmax_step(const float* s, bool valid, int G,
                                                    float* m, float* l, float (*acc)[4],
                                                    float* p) {
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      const float sg = valid ? s[g] : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(sg));
      p[g] = valid ? exp2f(sg - m_new) : 0.f;
      const float alpha = (m[g] == -INFINITY) ? 0.f : exp2f(m[g] - m_new);
      l[g] = l[g] * alpha + warp_sum(p[g]);
      acc[g][0] *= alpha;
      acc[g][1] *= alpha;
      acc[g][2] *= alpha;
      acc[g][3] *= alpha;
      m[g] = m_new;
    } else {
      p[g] = 0.f;
    }
  }
}

// Write one warp's split partials (lane owns head-dim slice [4*lane, 4*lane+4)).
__device__ __forceinline__ void store_partials(float* __restrict__ part_m,
                                               float* __restrict__ part_l,
                                               float* __restrict__ part_acc, size_t base,
                                               int G, const float* m, const float* l,
                                               float (*acc)[4], int lane) {
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        part_m[base + g] = m[g];
        part_l[base + g] = l[g];
      }
      *reinterpret_cast<float4*>(part_acc + (base + g) * HD + 4 * lane) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS) decode_combine_kernel(
    const bf16* __restrict__ q,         // [H, HD]
    const bf16* __restrict__ ksm,       // [E1, Hkv, HD] rotated delta ++ self rows
    const bf16* __restrict__ vsm,       // [E1, Hkv, HD]
    const float* __restrict__ part_m,   // [Hkv, n_splits, G]
    const float* __restrict__ part_l,
    const float* __restrict__ part_acc, // [Hkv, n_splits, G, HD]
    bf16* __restrict__ out,             // [H, HD]
    int Hkv, int G, int n_splits, int e1, int e_delta, int extra_visible,
    float qscale) {
  // one CTA per (kv head, query head of its group); thread d owns head-dim d
  __shared__ __align__(16) float sq[HD];
  __shared__ float s_small[EMAX];  // small-part logits, then softmax weights
  __shared__ float s_den;
  extern __shared__ float s_w[];   // [n_splits] split maxima, then weights
  const int kvh = blockIdx.x;
  const int g = blockIdx.y;
  const int h = kvh * G + g;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < HD; d += THREADS) {
    sq[d] = __bfloat162float(q[(size_t)h * HD + d]) * qscale;
  }
  for (int s = threadIdx.x; s < n_splits; s += THREADS) {
    s_w[s] = part_m[((size_t)kvh * n_splits + s) * G + g];
  }
  __syncthreads();

  // small-part logits: one row per warp iteration
  for (int j = warp; j < e1; j += NWARPS) {
    const bf16* row = ksm + ((size_t)j * Hkv + kvh) * HD;
    float part = 0.f;
#pragma unroll
    for (int d = lane; d < HD; d += 32) part += sq[d] * __bfloat162float(row[d]);
    part = warp_sum(part);
    if (lane == 0) {
      const bool vis = j < extra_visible || j >= e_delta;
      s_small[j] = vis ? part : -INFINITY;
    }
  }
  __syncthreads();

  // joint max, weights and denominator (warp 0; each lane owns its indices)
  if (warp == 0) {
    float mx = -INFINITY;
    for (int s = lane; s < n_splits; s += 32) mx = fmaxf(mx, s_w[s]);
    for (int j = lane; j < e1; j += 32) mx = fmaxf(mx, s_small[j]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float m = s_w[s];
      const float w = (m == -INFINITY) ? 0.f : exp2f(m - mx);
      s_w[s] = w;
      den += w * part_l[((size_t)kvh * n_splits + s) * G + g];
    }
    for (int j = lane; j < e1; j += 32) {
      const float sj = s_small[j];
      const float w = (sj == -INFINITY) ? 0.f : exp2f(sj - mx);
      s_small[j] = w;
      den += w;
    }
    den = warp_sum(den);
    if (lane == 0) s_den = fmaxf(den, 1e-20f);
  }
  __syncthreads();

  const int d = threadIdx.x;  // THREADS == HD
  float a = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_splits; ++s) {
    a += s_w[s] * part_acc[(((size_t)kvh * n_splits + s) * G + g) * HD + d];
  }
  for (int j = 0; j < e1; ++j) {
    a += s_small[j] * __bfloat162float(vsm[((size_t)j * Hkv + kvh) * HD + d]);
  }
  out[(size_t)h * HD + d] = __float2bfloat16(a / s_den);
}

// Launch the combine pass on `stream` (dynamic shared memory holds one float
// per split).
inline void launch_decode_combine(const bf16* q, const bf16* ksm, const bf16* vsm,
                                  const float* part_m, const float* part_l,
                                  const float* part_acc, bf16* out, int Hkv, int G,
                                  int n_splits, int e1, int e_delta, int extra_visible,
                                  float qscale, cudaStream_t s) {
  const size_t dyn = sizeof(float) * (size_t)n_splits;
  if (dyn > 40 * 1024) {  // static shared memory takes ~1.5 KB of the default 48
    cudaFuncSetAttribute(decode_combine_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  }
  decode_combine_kernel<<<dim3(Hkv, G), THREADS, dyn, s>>>(
      q, ksm, vsm, part_m, part_l, part_acc, out, Hkv, G, n_splits, e1, e_delta,
      extra_visible, qscale);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// signed byte k (0..3) of a 32-bit word
__device__ __forceinline__ float s8(uint32_t w, int k) {
  return (float)(((int32_t)(w << (24 - 8 * k))) >> 24);
}

// 16 consecutive channels [ch0, ch0 + 16) of one K or V row, dequantized to
// bf16 values (held as f32).
template <bool QUANT>
__device__ __forceinline__ void load16(const void* row, int ch0, float scale, float* out) {
  if constexpr (QUANT) {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(row) + ch0);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = round_bf16(__fmul_rn(s8(w[e >> 2], e & 3), scale));
  } else {
    const uint4* r = reinterpret_cast<const uint4*>(static_cast<const bf16*>(row) + ch0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint4 u = r[half];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(h[e]);
        out[8 * half + 2 * e] = x.x;
        out[8 * half + 2 * e + 1] = x.y;
      }
    }
  }
}

template <bool QUANT>
__global__ void __launch_bounds__(THREADS) decode_raw_split_kernel(
    const bf16* __restrict__ q,       // [H, HD]
    const void* __restrict__ kq,      // [C, Hkv, HD] raw K: int8 (QUANT) or bf16
    const float* __restrict__ ks,     // [C, Hkv] K scales (QUANT)
    const void* __restrict__ vq,      // [C, Hkv, HD]
    const float* __restrict__ vs,     // [C, Hkv] V scales (QUANT)
    const float* __restrict__ pos,    // [C, 3] f32 per-slot mRoPE positions
    const float* __restrict__ freqs,  // [3, HALF] masked inverse frequencies
    float* __restrict__ part_m,       // [Hkv, n_splits, G]
    float* __restrict__ part_l,
    float* __restrict__ part_acc,     // [Hkv, n_splits, G, HD]
    int Hkv, int G, int visible_len, int n_splits, float qscale) {
  extern __shared__ __align__(16) float smem[];
  float* scos = smem;                 // [HALF][SPLIT]
  float* ssin = scos + HALF * SPLIT;  // [HALF][SPLIT]
  float* sq = ssin + HALF * SPLIT;    // [H][HD], scaled by softmax-scale * log2(e)
  constexpr int ROW_BYTES = QUANT ? HD : HD * 2;
  const int H = Hkv * G;
  const int split = blockIdx.x;
  const int c_lo = split * SPLIT;
  const int n = min(SPLIT, visible_len - c_lo);
  for (int i = threadIdx.x; i < H * HD; i += THREADS) {
    sq[i] = __bfloat162float(q[i]) * qscale;
  }
  for (int i = threadIdx.x; i < HALF * SPLIT; i += THREADS) {
    const int ch = i / SPLIT;
    const int sl = i % SPLIT;
    float a = 0.f;
    if (sl < n) {
      const float* p = pos + (size_t)(c_lo + sl) * 3;
      a = p[0] * freqs[ch] + p[1] * freqs[HALF + ch] + p[2] * freqs[2 * HALF + ch];
    }
    sincosf(a, ssin + i, scos + i);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int kvh = warp; kvh < Hkv; kvh += NWARPS) {
    const float* sqh = sq + (size_t)kvh * G * HD;
    float m[GMAX], l[GMAX], acc[GMAX][4];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
      acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
    }
    for (int c0 = 0; c0 < n; c0 += 32) {
      // logits: lane = key (slot c_lo + sl)
      const int sl = c0 + lane;
      const bool valid = sl < n;
      float s[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
      float vscale = 0.f;
      if (valid) {
        const size_t ri = (size_t)(c_lo + sl) * Hkv + kvh;
        const float kscale = QUANT ? ks[ri] : 1.f;
        if (QUANT) vscale = vs[ri];
        const void* row = static_cast<const char*>(kq) + ri * ROW_BYTES;
#pragma unroll 1
        for (int j = 0; j < HALF / 16; ++j) {
          float a[16], b[16];  // channels 16j.. (first half) and HALF+16j.. (second)
          load16<QUANT>(row, 16 * j, kscale, a);
          load16<QUANT>(row, HALF + 16 * j, kscale, b);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int ch = 16 * j + e;
            const float cs = scos[ch * SPLIT + sl];
            const float sn = ssin[ch * SPLIT + sl];
            const float r1 = round_bf16(__fsub_rn(__fmul_rn(a[e], cs), __fmul_rn(b[e], sn)));
            const float r2 = round_bf16(__fadd_rn(__fmul_rn(b[e], cs), __fmul_rn(a[e], sn)));
            a[e] = r1;
            b[e] = r2;
          }
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < G) {
              const float* qa = sqh + g * HD + 16 * j;
              const float* qb = qa + HALF;
#pragma unroll
              for (int e = 0; e < 16; e += 4) {
                const float4 x = *reinterpret_cast<const float4*>(qa + e);
                const float4 y = *reinterpret_cast<const float4*>(qb + e);
                s[g] += x.x * a[e] + x.y * a[e + 1] + x.z * a[e + 2] + x.w * a[e + 3] +
                        y.x * b[e] + y.y * b[e + 1] + y.z * b[e + 2] + y.w * b[e + 3];
              }
            }
          }
        }
      }
      float p[GMAX];
      online_softmax_step(s, valid, G, m, l, acc, p);
      // P.V: lane owns head-dim slice [4*lane, 4*lane + 4)
      const int nn = min(32, n - c0);
#pragma unroll 8
      for (int j = 0; j < nn; ++j) {
        const size_t ri = (size_t)(c_lo + c0 + j) * Hkv + kvh;
        float v[4];
        if constexpr (QUANT) {
          const float vsc = __shfl_sync(0xffffffffu, vscale, j);
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              static_cast<const int8_t*>(vq) + ri * HD + 4 * lane);
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = round_bf16(__fmul_rn(s8(w, k), vsc));
        } else {
          const uint2 u = *reinterpret_cast<const uint2*>(
              static_cast<const bf16*>(vq) + ri * HD + 4 * lane);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
          const float2 v01 = __bfloat1622float2(h[0]);
          const float2 v23 = __bfloat1622float2(h[1]);
          v[0] = v01.x;
          v[1] = v01.y;
          v[2] = v23.x;
          v[3] = v23.y;
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            const float pj = __shfl_sync(0xffffffffu, p[g], j);
            acc[g][0] += pj * v[0];
            acc[g][1] += pj * v[1];
            acc[g][2] += pj * v[2];
            acc[g][3] += pj * v[3];
          }
        }
      }
    }
    store_partials(part_m, part_l, part_acc, ((size_t)kvh * n_splits + split) * G, G, m, l,
                   acc, lane);
  }
}

template <bool QUANT>
cudaError_t launch_raw_split(const void* q, const void* kq, const void* ks, const void* vq,
                             const void* vs, const void* pos, const void* freqs,
                             void* part_m, void* part_l, void* part_acc, int Hkv, int G,
                             int visible_len, int n_splits, float qscale, cudaStream_t s) {
  const size_t dyn = sizeof(float) * (2 * HALF * SPLIT + (size_t)Hkv * G * HD);
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_raw_split_kernel<QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return e;
  }
  decode_raw_split_kernel<QUANT><<<n_splits, THREADS, dyn, s>>>(
      (const bf16*)q, kq, (const float*)ks, vq, (const float*)vs, (const float*)pos,
      (const float*)freqs, (float*)part_m, (float*)part_l, (float*)part_acc, Hkv, G,
      visible_len, n_splits, qscale);
  return cudaSuccess;
}

}  // namespace

// K3's split: SPLIT arena slots per CTA (K2 picks its own per call). Its
// scratch part_m / part_l / part_acc holds ceil(visible_len / SPLIT)
// splits; the wrapper allocates it and may pass null pointers when
// visible_len == 0.
extern "C" int svt_decode_split_size() { return SPLIT; }

// K3. quantized != 0: kq/vq are int8 with f32 scales ks/vs [C, Hkv];
// quantized == 0: kq/vq are bf16 and ks/vs are ignored.
extern "C" int svt_decode_attention_raw(
    const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
    const void* pos, const void* freqs, const void* ksm, const void* vsm, void* part_m,
    void* part_l, void* part_acc, void* out, int H, int Hkv, int hd, int e1, int e_delta,
    int visible_len, int extra_visible, int quantized, void* stream) {
  if (hd != HD || H % Hkv != 0 || H / Hkv > GMAX || e1 > EMAX || e1 <= e_delta) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = H / Hkv;
  const float qscale = LOG2E / sqrtf((float)hd);
  const int n_splits = (visible_len + SPLIT - 1) / SPLIT;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_splits > 0) {
    const cudaError_t e =
        quantized ? launch_raw_split<true>(q, kq, ks, vq, vs, pos, freqs, part_m, part_l,
                                           part_acc, Hkv, G, visible_len, n_splits, qscale, s)
                  : launch_raw_split<false>(q, kq, ks, vq, vs, pos, freqs, part_m, part_l,
                                            part_acc, Hkv, G, visible_len, n_splits, qscale, s);
    if (e != cudaSuccess) return (int)e;
  }
  launch_decode_combine((const bf16*)q, (const bf16*)ksm, (const bf16*)vsm,
                        (const float*)part_m, (const float*)part_l, (const float*)part_acc,
                        (bf16*)out, Hkv, G, n_splits, e1, e_delta, extra_visible, qscale, s);
  return (int)cudaGetLastError();
}
