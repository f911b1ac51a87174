// Multi-query verify attention over the pre-rotated arena: kernel
// K2-verify of the port, the attention of one speculative-decoding verify
// round (T = k + 1 tokens of one stream at once).
//
// The JAX package computes this attention in XLA (`_gqa_attention_multi`,
// streaming_vlm_tpu/models/qwen25_vl/language.py, reached from
// `language_forward_streaming`'s decode-delta path at T = k_pad). Query t
// (t < T) sees three parts under one joint softmax: arena slots <
// visible_len, delta rows k_small[:e_delta] below extra_visible, and the
// self rows k_small[e_delta:e_delta + t + 1] (the T tokens' own K/V,
// causal).
//
// It is K2 (decode_attention.cu) with the T queries of a CTA's rows taken
// in turn over rows staged once:
//   * grid (splits + the small block, kv heads): the host picks the split
//     exactly as for K2 (ops/attention.py `decode_split_size`), so each
//     split's K and V rows cross HBM once a launch, not T times: one warp
//     stages them with one cp.async.bulk per row, counted on four
//     mbarriers, and Q.K starts on the first rows while the rest fly;
//   * for each query t in turn: its scaled queries in registers, Q.K by the
//     transposing butterfly, the softmax of each query head by one warp and
//     P.V by four quarters of the threads, all as K2 does it, then the
//     part's partial (m, l, acc) for t stored (the quarters meet in a
//     buffer of their own: the K tile must outlive the t loop). The small
//     block's query t reads only its first e_delta + t + 1 rows;
//   * one arrival a CTA on its kv head's counter after all T partials; the
//     last CTA folds the n_parts partials of each t in turn
//     (decode_common.cuh `fold_parts`) and resets the counter.
// So row t of the output is bitwise K2 called on query t with k_small cut
// to its first e_delta + t + 1 rows: the same splits, the same order of
// every f32 sum. The arithmetic per query is K2's f32 work, so the CTA's
// time grows with T while its bytes do not (a tensor-core form, all T * G
// query rows in one mma.sync m16n8k16 pass, is the faster design).

#include "decode_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 160;  // rows staged at once: the largest split, and the small block
constexpr int ROW_BYTES = HD * 2;
constexpr int CHUNKS = 4;
constexpr int CHUNK = TILE / CHUNKS;
constexpr int TMAX = 16;  // the most queries a call takes
constexpr size_t VERIFY_SMEM = 2 * (size_t)TILE * ROW_BYTES            // K, V tiles
                               + sizeof(float) * GMAX * HD               // scaled q of query t
                               + sizeof(float) * GMAX * TILE             // logits, then weights
                               + sizeof(float) * QUARTERS * GMAX * HD    // the quarters' P.V
                               + sizeof(float) * 4 * GMAX                // m, l, alpha, den
                               + sizeof(uint64_t) * CHUNKS;              // mbarriers
// the fold keeps one weight per (query head, part) in the K tile
constexpr int MAX_PARTS = TILE * ROW_BYTES / (GMAX * (int)sizeof(float));

static_assert(CHUNK % 4 == 0, "a warp's group of 4 rows lies in one chunk");
static_assert(QUARTERS * GMAX * HD * sizeof(float) <= TILE * ROW_BYTES, "the fold fits in a tile");

// One split (or the small block) of one kv head, for all T queries -> T
// partials (m, l, acc) in part_* [T * Hkv, gridDim.x, G(, HD)] (query t's
// at head t * Hkv + kvh); the last CTA of the kv head folds each query's
// into out [T, H, HD].
__global__ void __launch_bounds__(DEC_THREADS, 2) verify_split_kernel(
    const bf16* __restrict__ q,    // [T, H, HD]
    const bf16* __restrict__ ka,   // [C, Hkv, HD] pre-rotated
    const bf16* __restrict__ va,   // [C, Hkv, HD]
    const bf16* __restrict__ ksm,  // [e_delta + T, Hkv, HD] rotated delta ++ self rows
    const bf16* __restrict__ vsm,
    float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc,
    int* __restrict__ counters,  // [Hkv], zero between calls
    bf16* __restrict__ out,      // [T, H, HD]
    int visible_len, int Hkv, int G, int split_rows, int T, int e_delta, int extra_visible,
    float qscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sk = smem;                                      // [TILE][HD] bf16
  unsigned char* sv = sk + TILE * ROW_BYTES;                     // [TILE][HD] bf16
  float* sq = reinterpret_cast<float*>(sv + TILE * ROW_BYTES);  // [GMAX][HD]
  float* sp = sq + GMAX * HD;                                    // [GMAX][TILE]
  float* sred = sp + GMAX * TILE;                                // [QUARTERS][GMAX][HD]
  float* s_m = sred + QUARTERS * GMAX * HD;
  float* s_l = s_m + GMAX;
  float* s_alpha = s_l + GMAX;
  float* s_den = s_alpha + GMAX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_den + GMAX);
  __shared__ int s_last;

  const int kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_parts = gridDim.x;  // the splits + the small block
  const int n_splits = n_parts - 1;
  const bool small = blockIdx.x == n_splits;
  const int part = blockIdx.x;
  const size_t H = (size_t)Hkv * G;
  const bf16* kbase = small ? ksm : ka;
  const bf16* vbase = small ? vsm : va;
  const int row0 = small ? 0 : part * split_rows;
  // the staged rows: the split's, or every delta and self row
  const int rows = small ? e_delta + T : min(split_rows, visible_len - row0);

  if (warp == 0) {
    if (lane < CHUNKS) {
      mbar_init(&bar[lane], 1);
      mbar_fence_init();
    }
    __syncwarp();
    if (lane < CHUNKS && lane * CHUNK < rows) {
      mbar_arrive_expect_tx(&bar[lane], 2u * min(CHUNK, rows - lane * CHUNK) * ROW_BYTES);
    }
    __syncwarp();
    for (int j = lane; j < rows; j += 32) {
      const size_t src = ((size_t)(row0 + j) * Hkv + kvh) * HD;
      bulk_load(sk + j * ROW_BYTES, kbase + src, ROW_BYTES, &bar[j / CHUNK]);
      bulk_load(sv + j * ROW_BYTES, vbase + src, ROW_BYTES, &bar[j / CHUNK]);
    }
  }
  const int dp = tid % (HD / 2), quarter = tid / (HD / 2);

  for (int t = 0; t < T; ++t) {
    // query t's scaled queries, its running max and sum
    for (int i = tid; i < GMAX * HD; i += DEC_THREADS) {
      sq[i] = i < G * HD ? __bfloat162float(q[((size_t)t * H + (size_t)kvh * G) * HD + i]) * qscale
                         : 0.f;
    }
    if (tid < GMAX) {
      s_m[tid] = -INFINITY;
      s_l[tid] = 0.f;
    }
    __syncthreads();

    float qr[GMAX][4];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(sq + g * HD + 4 * lane);
      qr[g][0] = v.x;
      qr[g][1] = v.y;
      qr[g][2] = v.z;
      qr[g][3] = v.w;
    }
    float acc[GMAX][2];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) acc[g][0] = acc[g][1] = 0.f;
    // the rows query t reads: the split's, or the delta rows and self rows <= t
    const int n = small ? e_delta + t + 1 : rows;
    const int n4 = (n + 3) / 4 * 4;

    // logits: warp w takes the groups of 4 rows starting at 4 (w + 8 i)
    for (int j0 = 4 * warp; j0 < n; j0 += 4 * DEC_WARPS) {
      if (t == 0 && j0 % CHUNK < 4 * DEC_WARPS) mbar_wait(&bar[j0 / CHUNK], 0);
      float v[32];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint2 u = *reinterpret_cast<const uint2*>(sk + (j0 + r) * ROW_BYTES + 8 * lane);
        const float2 k01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 k23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          v[r * GMAX + g] =
              qr[g][0] * k01.x + qr[g][1] * k01.y + qr[g][2] * k23.x + qr[g][3] * k23.y;
        }
      }
      butterfly<16>(v, lane);
      butterfly<8>(v, lane);
      butterfly<4>(v, lane);
      butterfly<2>(v, lane);
      butterfly<1>(v, lane);
      const int g = lane % GMAX, j = j0 + lane / GMAX;
      const bool vis = j < n && (!small || j < extra_visible || j >= e_delta);
      if (g < G) sp[g * TILE + j] = vis ? v[0] : -INFINITY;
    }
    // every staged chunk has landed (later queries read rows this one did not)
    if (t == 0) {
      for (int c = 0; c * CHUNK < rows; ++c) mbar_wait(&bar[c], 0);
    }
    __syncthreads();

    // softmax of query head g over the rows: warp g
    if (warp < G) {
      const int g = warp;
      float mx = -INFINITY;
      for (int j = lane; j < n4; j += 32) mx = fmaxf(mx, sp[g * TILE + j]);
      mx = warp_max(mx);
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < n4; j += 32) {
        const float p = exp2f(sp[g * TILE + j] - base);
        sp[g * TILE + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - base);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // P.V: head dims 2 dp + {0, 1} of the groups of 4 rows starting at 4 (quarter + 4 i)
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float a = g < G ? s_alpha[g] : 0.f;
      acc[g][0] *= a;
      acc[g][1] *= a;
    }
    for (int j0 = 4 * quarter; j0 < n; j0 += 4 * QUARTERS) {
      float2 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        v[r] = j0 + r < n ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                sv + (j0 + r) * ROW_BYTES + 4 * dp))
                          : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float4 p = *reinterpret_cast<const float4*>(sp + g * TILE + j0);
          acc[g][0] += p.x * v[0].x + p.y * v[1].x + p.z * v[2].x + p.w * v[3].x;
          acc[g][1] += p.x * v[0].y + p.y * v[1].y + p.z * v[2].y + p.w * v[3].y;
        }
      }
    }
    __syncthreads();  // sp and s_alpha are free for the next query
    store_partial(acc, sred, s_m, s_l, part_m, part_l, part_acc, t * Hkv + kvh, part, n_parts,
                  G);
  }

  // one arrival for the T partials; the last CTA of the kv head folds each query's
  if (!arrive_last(counters, kvh, n_parts, &s_last)) return;
  for (int t = 0; t < T; ++t) {
    __syncthreads();  // the previous query's fold has read the tiles
    fold_parts<true>(reinterpret_cast<float*>(sk), reinterpret_cast<float*>(sv), s_m, s_den,
                     part_m, part_l, part_acc, out + (size_t)t * H * HD, nullptr, nullptr, nullptr,
                     t * Hkv + kvh, kvh, n_parts, n_parts, G);
  }
  if (tid == 0) counters[kvh] = 0;  // ready for the next call
}

}  // namespace

// the largest split, the most parts (splits + the small block), the most
// queries, and the most small-block rows (e_delta + T) a call may have
extern "C" int svt_verify_max_split() { return TILE; }
extern "C" int svt_verify_max_parts() { return MAX_PARTS; }
extern "C" int svt_verify_max_queries() { return TMAX; }
extern "C" int svt_verify_max_small_rows() { return TILE; }

// K2-verify: q [T, H, HD], arenas [C, Hkv, HD], small block [e_delta + T,
// Hkv, HD], out [T, H, HD]. Scratch: part_m / part_l [T * Hkv, n_parts, G],
// part_acc [T * Hkv, n_parts, G, HD] f32 and counters [Hkv] int32 (zero
// between calls), n_parts = ceil(visible_len / split_rows) + 1.
extern "C" int svt_verify_attention(
    const void* q, const void* ka, const void* va, const void* ksm, const void* vsm,
    void* part_m, void* part_l, void* part_acc, void* counters, void* out, int T, int H, int Hkv,
    int hd, int e_delta, int visible_len, int extra_visible, int split_rows, void* stream) {
  if (hd != HD || H % Hkv != 0 || H / Hkv > GMAX || T < 1 || T > TMAX || e_delta < 0 ||
      e_delta + T > TILE || extra_visible < 0 || extra_visible > e_delta || visible_len < 0 ||
      split_rows < 1 || split_rows > TILE) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_splits = (visible_len + split_rows - 1) / split_rows;
  if (n_splits + 1 > MAX_PARTS) return (int)cudaErrorInvalidValue;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        verify_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)VERIFY_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const dim3 grid(n_splits + 1, Hkv);
  verify_split_kernel<<<grid, DEC_THREADS, VERIFY_SMEM, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const bf16*)q, (const bf16*)ka, (const bf16*)va, (const bf16*)ksm, (const bf16*)vsm,
      (float*)part_m, (float*)part_l, (float*)part_acc, (int*)counters, (bf16*)out, visible_len,
      Hkv, H / Hkv, split_rows, T, e_delta, extra_visible, LOG2E / sqrtf((float)HD));
  return (int)cudaGetLastError();
}
